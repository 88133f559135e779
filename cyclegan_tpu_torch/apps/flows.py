"""Data-acquisition flows (cyclegan_tpu/apps/flows.py): plain CLIs with
thread-pool parallelism in place of the reference's Prefect flows.

    python -m cyclegan_tpu_torch.apps.flows download --breeds "Tabby" \\
        "Tortoiseshell" --destination data/raw --pages 10
    python -m cyclegan_tpu_torch.apps.flows tfrecords --images data/raw/Tabby \\
        --destination data/tabby_records --size 256
    python -m cyclegan_tpu_torch.apps.flows fetch --records_dir \\
        data/tabby_records --remote /mnt/datasets/tabby_records

``download`` calls the Petfinder v2 REST API with the standard library's
``urllib`` and needs PETFINDER_KEY and PETFINDER_SECRET; ``tfrecords``
shards image folders with ``data/tfrecord.py`` ``tfrecord_writer``;
``fetch`` copies manifest-pinned shards from a remote
(``data/manifest.py`` ``fetch_from_remote``).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import logging
import os
import urllib.parse
import urllib.request
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

PETFINDER_TOKEN_URL = "https://api.petfinder.com/v2/oauth2/token"
PETFINDER_ANIMALS_URL = "https://api.petfinder.com/v2/animals"


def _petfinder_token(key: str, secret: str) -> str:
    body = urllib.parse.urlencode(
        dict(grant_type="client_credentials", client_id=key,
             client_secret=secret)).encode()
    request = urllib.request.Request(PETFINDER_TOKEN_URL, data=body)
    with urllib.request.urlopen(request) as response:
        return json.loads(response.read())["access_token"]


def get_photo_urls(token: str, breed: str, pages: int) -> List[str]:
    """The large-size cat photo URLs of a breed, 100 results a page, until
    ``pages`` pages or the last one."""
    urls: List[str] = []
    for page in range(1, pages + 1):
        query = urllib.parse.urlencode(
            dict(type="cat", breed=breed, limit=100, page=page))
        request = urllib.request.Request(
            f"{PETFINDER_ANIMALS_URL}?{query}",
            headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(request) as response:
            payload = json.loads(response.read())
        for animal in payload.get("animals", []):
            for photo in animal.get("photos", []):
                if "large" in photo:
                    urls.append(photo["large"])
        if not payload.get("pagination", {}).get("_links", {}).get("next"):
            break
    return urls


def download_photos(urls: List[str], destination: Path, breed: str,
                    workers: int = 16) -> int:
    """Download ``urls`` into ``destination/breed/NNNNN.png`` on a thread
    pool; a URL that fails is logged and skipped. Returns the count
    saved."""
    breed_dir = Path(destination, breed)
    breed_dir.mkdir(parents=True, exist_ok=True)

    def fetch(args) -> int:
        index, url = args
        try:
            urllib.request.urlretrieve(url, breed_dir / f"{index:05}.png")
            return 1
        except Exception as exc:  # noqa: BLE001 - skip bad URLs, keep going
            logger.warning("failed %s: %s", url, exc)
            return 0

    with cf.ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(fetch, enumerate(urls)))


def download_flow(breeds: List[str], destination: Path, pages: int) -> None:
    key = os.getenv("PETFINDER_KEY")
    secret = os.getenv("PETFINDER_SECRET")
    if not key or not secret:
        raise SystemExit("set PETFINDER_KEY and PETFINDER_SECRET")
    token = _petfinder_token(key, secret)
    for breed in breeds:
        urls = get_photo_urls(token, breed, pages)
        count = download_photos(urls, destination, breed)
        logger.info("downloaded %d/%d photos for %s", count, len(urls), breed)


def tfrecords_flow(images: List[Path], destinations: List[Path],
                   size: Optional[int]) -> None:
    """Shard each image folder into TFRecords in its destination."""
    from cyclegan_tpu_torch.data.tfrecord import tfrecord_writer

    for images_path, destination in zip(images, destinations):
        shards = tfrecord_writer(images_path, destination, image_size=size)
        logger.info("%s -> %d shards in %s", images_path, len(shards),
                    destination)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("cyclegan_tpu_torch data flows")
    sub = parser.add_subparsers(dest="command", required=True)

    dl = sub.add_parser("download", help="Petfinder batch image downloader")
    dl.add_argument("--breeds", nargs="+", required=True)
    dl.add_argument("--destination", type=Path, default=Path("data/raw"))
    dl.add_argument("--pages", type=int, default=10)

    tr = sub.add_parser("tfrecords", help="TFRecord writer")
    tr.add_argument("--images", nargs="+", type=Path, required=True)
    tr.add_argument("--destination", nargs="+", type=Path, required=True)
    tr.add_argument("--size", type=int, default=None)

    fe = sub.add_parser(
        "fetch",
        help="dvc pull equivalent: materialize manifest-pinned shards "
        "from a remote (URL or directory), sha256-verified")
    fe.add_argument("--records_dir", nargs="+", type=Path, required=True)
    fe.add_argument("--remote", nargs="+", required=True,
                    help="one remote per records_dir (or one for all)")

    args = parser.parse_args(argv)
    if args.command == "download":
        download_flow(args.breeds, args.destination, args.pages)
    elif args.command == "fetch":
        from cyclegan_tpu_torch.data.manifest import fetch_from_remote

        remotes = args.remote
        if len(remotes) == 1:
            remotes = remotes * len(args.records_dir)
        for records_dir, remote in zip(args.records_dir, remotes):
            result = fetch_from_remote(records_dir, remote)
            logger.info("%s: fetched %d, cached %d", records_dir,
                        len(result["fetched"]), len(result["cached"]))
    else:
        tfrecords_flow(args.images, args.destination, args.size)


if __name__ == "__main__":
    main()
