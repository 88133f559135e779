"""Content-addressed dataset manifests (cyclegan_tpu/data/manifest.py):
pin, verify and fetch TFRecord shards without DVC.

- **pin**: ``write_manifest`` records the sha256, byte size and record
  count of every ``*.tfrecords`` shard of a directory in
  ``manifest.json`` (``tfrecord_writer`` writes it);
- **verify**: ``verify_manifest`` hashes the shards again and raises
  :class:`ManifestMismatch` on any content or shard-set drift;
- **fetch** (``dvc pull``'s counterpart): ``fetch_from_remote`` copies the
  pinned shards from a remote, a directory or a URL urllib can open
  (``file://``, ``http(s)://``), idempotently and sha256-verified,
  fetching only what is missing or corrupt.

The manifest's layout is the JAX package's, so either package verifies
and fetches the other's datasets.
"""

from __future__ import annotations

import hashlib
import json
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Dict, Optional, Union

from cyclegan_tpu_torch.data.tfrecord import read_tfrecord_file

MANIFEST_NAME = "manifest.json"


class ManifestMismatch(Exception):
    """Dataset content differs from its pinned manifest."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(records_dir: Union[str, Path],
                   extra: Optional[Dict] = None) -> Path:
    """Pin every ``*.tfrecords`` shard under ``records_dir``; ``extra``
    carries the writer's provenance (image_size, shard_size, seed,
    writer). Returns the manifest's path."""
    records_dir = Path(records_dir)
    files = {}
    total = 0
    for shard in sorted(records_dir.glob("*.tfrecords")):
        count = sum(1 for _ in read_tfrecord_file(shard))
        files[shard.name] = {"sha256": _sha256_file(shard),
                             "bytes": shard.stat().st_size,
                             "records": count}
        total += count
    manifest = {"files": files, "total_records": total}
    if extra:
        manifest["extra"] = dict(extra)
    path = records_dir / MANIFEST_NAME
    path.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    return path


def load_manifest(records_dir: Union[str, Path]) -> Dict:
    return json.loads((Path(records_dir) / MANIFEST_NAME).read_text())


def verify_manifest(records_dir: Union[str, Path]) -> Dict:
    """Hash the shards against the pinned manifest; raise
    :class:`ManifestMismatch` on content drift (a sha256 that differs) or
    shard-set drift (a missing or unexpected ``*.tfrecords``). Returns the
    manifest."""
    records_dir = Path(records_dir)
    manifest = load_manifest(records_dir)
    pinned = manifest["files"]
    on_disk = {p.name for p in records_dir.glob("*.tfrecords")}
    if on_disk != set(pinned):
        raise ManifestMismatch(
            f"shard set drift in {records_dir}: manifest pins "
            f"{sorted(pinned)}, directory has {sorted(on_disk)}")
    for name, meta in pinned.items():
        digest = _sha256_file(records_dir / name)
        if digest != meta["sha256"]:
            raise ManifestMismatch(
                f"content drift in {records_dir / name}: "
                f"sha256 {digest} != pinned {meta['sha256']}")
    return manifest


def _read_remote(remote: str, name: str) -> bytes:
    """One file of a remote: a URL through urllib, else a directory."""
    if "://" in remote:
        base = remote if remote.endswith("/") else remote + "/"
        with urllib.request.urlopen(urllib.parse.urljoin(base, name)) as r:
            return r.read()
    return (Path(remote) / name).read_bytes()


def fetch_from_remote(local_dir: Union[str, Path],
                      remote: str) -> Dict[str, list]:
    """Copy the shards that ``remote``'s manifest pins into ``local_dir``:
    each one missing locally or failing its sha256 is read, checked
    against its pin and only then moved into place (through a ``.fetch``
    name, so no partial shard appears). A remote shard that does not match
    its own manifest raises :class:`ManifestMismatch` and leaves no file.
    Returns ``{"fetched": [...], "cached": [...]}``."""
    local_dir = Path(local_dir)
    local_dir.mkdir(parents=True, exist_ok=True)
    manifest = json.loads(_read_remote(remote, MANIFEST_NAME).decode("utf-8"))

    fetched, cached = [], []
    for name, meta in sorted(manifest["files"].items()):
        dest = local_dir / name
        if dest.exists() and _sha256_file(dest) == meta["sha256"]:
            cached.append(name)
            continue
        data = _read_remote(remote, name)
        if _sha256(data) != meta["sha256"]:
            raise ManifestMismatch(
                f"remote shard {name} does not match its manifest pin "
                f"(remote {remote} is corrupt or mid-update)")
        tmp = local_dir / (name + ".fetch")
        tmp.write_bytes(data)
        tmp.replace(dest)
        fetched.append(name)

    (local_dir / MANIFEST_NAME).write_text(
        json.dumps(manifest, indent=2, sort_keys=True))
    return {"fetched": fetched, "cached": cached}
