"""A configuration, a traffic mix and a per-layer metric are taken up
from added files and entries alone, with no file of the harness edited."""
import json
import pathlib
import shutil

from portbench import harness
from portbench.catalog import find_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]

TINY_MIX = {
    "loop": "closed",
    "clients": 3,
    "sample_per_template": 2,
    "prefixes": {"ub": "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"},
    "templates": [
        {"name": "T1", "select": ["?p"], "distinct": True,
         "where": [["?p", "ub:worksFor", "?d"], ["?p", "ub:teacherOf", "?c"]]},
    ],
}
TINY_METRIC = '''
def read(ctx):
    return float(len(ctx["records"]))
'''


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "lubm100.json").read_text())
    cfg.update(name="tiny", universities=1)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tinymix.json").write_text(json.dumps(TINY_MIX))
    (pb / "metrics" / "tiny_requests.py").write_text(TINY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.tinymix", "config": "tiny",
                               "traffic": "tinymix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tiny_requests", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "server", "moves": "qps",
                               "workloads": ["tiny.tinymix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("tiny.tinymix", root)
    assert cell.config["universities"] == 1
    assert [m["name"] for m in cell.per_layer] == ["tiny_requests"]
    res = harness.run(cell, 77, 0.5, trace=True, device="cpu")
    assert res["correct"] is True, res
    assert res["metrics"]["tiny_requests"]["value"] == res["attempted"] > 0
    res = harness.run(cell, 78, 0.5, trace=False, device="cpu")
    assert res["correct"] is True, res
    assert set(res["metrics"]) == {"qps", "p95_ms", "peak_device_gib",
                                   "setup_s"}
