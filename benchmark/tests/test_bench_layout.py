"""A later change adds a configuration, a traffic mix, a cell, a
per-layer metric or a kernel family as new files and entries in
BENCHMARK.json, and edits no file the benchmark has: the harness finds
each by its name. Shown on a copy of the benchmark into which only new
files are written and whose existing files are then compared byte for
byte with the originals."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import spec, trace

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def checkout(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    yield tmp_path
    for path, content in before.items():
        assert path.read_bytes() == content, f"{path} was edited"


def add(root: Path, relative: str, content) -> None:
    path = root / relative
    assert not path.exists()
    path.write_text(content if isinstance(content, str)
                    else json.dumps(content))


def test_new_config_traffic_cell_metric_and_family(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    config = json.loads((checkout / "benchmark/configs/unet256.json")
                        .read_text())
    add(checkout, "benchmark/configs/unet512.json",
        dict(config, name="unet512", image_size=512))
    add(checkout, "benchmark/traffic/train.b4.json",
        {"driver": "train", "records": 16, "check_steps": 3,
         "issue_steps": 3, "traced_steps": 2})
    add(checkout, "benchmark/workloads/unet512.train.b4.json",
        {"limits": {"loss1_gap": 0.01}})
    add(checkout, "benchmark/metrics/peak_mem_gib.train.py",
        "def read(records):\n    return records.get('peak_gib')\n")
    add(checkout, "benchmark/families/new_kernel.json",
        {"fragments": ["my_new_kernel"], "conv": True})
    bench["configs"].append({"name": "unet512", "source": "x",
                             "file": "benchmark/configs/unet512.json",
                             "reduced": [], "why": "y"})
    bench["workloads"].append({"name": "unet512.train.b4",
                               "config": "unet512", "traffic": "train.b4",
                               "chips": 1, "why": "z"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("unet512.train.b4")
    bench["per_layer"].append({
        "name": "peak_mem_gib.train", "unit": "GiB", "better": "lower",
        "source": "host_clock", "layer": "train step",
        "moves": "train_img_s", "workloads": ["unet512.train.b4"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("unet512.train.b4", root=checkout)
    assert cell.config["image_size"] == 512
    assert cell.traffic["records"] == 16
    assert cell.limits == {"loss1_gap": 0.01}
    assert "train_img_s" in {m["name"] for m in cell.end_to_end}
    assert [m["name"] for m in cell.per_layer] == ["peak_mem_gib.train"]
    reader = spec.metric_reader("peak_mem_gib.train", root=checkout)
    assert reader({"peak_gib": 3.5}) == 3.5
    table = spec.families(root=checkout)
    assert spec.family_of("void my_new_kernel<bf16>", table) == "new_kernel"


def test_a_new_family_is_read_from_the_trace(checkout, monkeypatch):
    add(checkout, "benchmark/families/new_kernel.json",
        {"fragments": ["my_new_kernel"], "conv": True})
    monkeypatch.setattr(spec, "ROOT", checkout)
    monkeypatch.setattr(spec.families, "__defaults__", (checkout,))
    events = [
        {"ph": "X", "cat": "cpu_op", "name": trace.WINDOW_MARK, "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "my_new_kernel", "ts": 40,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 60,
         "dur": 20},
    ]
    read = trace.read(events, window_s=100e-6)
    assert read["conv_s"] == pytest.approx(30e-6)
    assert read["busy_s"] == pytest.approx(40e-6)
    assert dict(read["device_ops"])["new_kernel"] == pytest.approx(30e-6)
    idle = dict(read["idle_gaps"])
    assert idle["host: aten::copy_"] == pytest.approx(40e-6)
    assert idle["host: no operation"] == pytest.approx(20e-6)
