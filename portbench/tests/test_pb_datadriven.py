"""The harness finds a new configuration, traffic mix and per-layer metric
by their names alone: no code of the harness is edited."""

import json

from portbench.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    pb = tiny.make_copy(tmp_path)
    cfg = json.loads((pb / "configs" / "sampled_he4.json").read_text())
    cfg.update(name="sampled_he2", layers=2, num_samples=64)
    (pb / "configs" / "sampled_he2.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "tiny_sampled.json").read_text())
    traffic.update(num_latent=5, num_vars=6, observed={"5": 1})
    (pb / "traffic" / "tiny5.json").write_text(json.dumps(traffic))
    (pb / "limits" / "new_cell.json").write_text(
        (pb / "limits" / "tiny_sampled.json").read_text())
    (pb / "metrics" / "shots_per_epoch.py").write_text(
        "def read(run):\n    return float(run.problem['num_samples'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sampled_he2", "source": "test",
                             "file": "portbench/configs/sampled_he2.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "new_cell", "config": "sampled_he2",
                               "traffic": "tiny5", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "shots_per_epoch", "unit": "shots", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["new_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "epochs_per_s":
            m["workloads"].append("new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = tiny.run(pb, "new_cell")
    assert res["correct"], res["checks"]
    assert res["metrics"]["shots_per_epoch"] == {"value": 64.0, "unit": "shots"}
    assert "epochs_per_s" in res["metrics"]


def test_a_new_engine_kind_is_found_by_name(tmp_path):
    pb = tiny.make_copy(tmp_path)
    for part in ("reference", "counts"):
        (pb / part / "exact2.py").write_text((pb / part / "exact.py").read_text())
    cfg = json.loads((pb / "configs" / "exact_bn8.json").read_text())
    cfg.update(name="exact2_bn8", kind="exact2", layers=2)
    (pb / "configs" / "exact2_bn8.json").write_text(json.dumps(cfg))
    (pb / "limits" / "kind_cell.json").write_text(
        (pb / "limits" / "tiny_exact.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "exact2_bn8", "source": "test",
                             "file": "portbench/configs/exact2_bn8.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "kind_cell", "config": "exact2_bn8",
                               "traffic": "tiny_exact", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = tiny.run(pb, "kind_cell")
    assert res["correct"], res["checks"]
    assert set(res["numbers"]) == {"loss_rel", "grad_rel", "step_rel", "q_rel", "q_l1"}


def test_layer_files_naming_one_layer_add_up(tmp_path):
    from portbench.harness import load_layers

    pb = tiny.make_copy(tmp_path)
    before = load_layers(pb)
    (pb / "layers" / "engines_more.json").write_text(
        json.dumps({"layer": "engines", "modules": ["pkg/engines/new.py"]}))
    after = load_layers(pb)
    assert after["engines"]["modules"] == before["engines"]["modules"] + ["pkg/engines/new.py"]
    assert {k: v for k, v in after.items() if k != "engines"} == {
        k: v for k, v in before.items() if k != "engines"}
