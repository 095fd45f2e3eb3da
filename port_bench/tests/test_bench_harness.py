"""The harness's bookkeeping on the CPU: what it imports, how it finds a
cell's parts, BENCHMARK.json's names and units, the counts of FLOPs and
bytes, the idle share and the training window's waits."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import cells, flops, kernel_layers, readers, trace, traffic
from port_bench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imported(path: Path):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = set(_imported(path)) & set(FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        names = set(_imported(path))
        assert "neural_image_compression_tpu_torch" not in names, path
        assert not names & set(FORBIDDEN), path


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden_modules({"neural_image_compression_tpu_torch.models": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"jax.numpy": 1, "neural_image_compression_tpu": 1}) == [
        "jax", "neural_image_compression_tpu"]


def test_cpu_rehearsal_loads_no_forbidden_module():
    code = ("import sys, torch\n"
            "from port_bench.tests.tiny import tiny_cell\n"
            "from port_bench.session import Session\n"
            "from port_bench.run import forbidden_modules\n"
            "for name in ('gm128k3.train_f32_b16', 'scal192.serve_bf16_kodak24'):\n"
            "    s = Session(tiny_cell(name, m=8, size=64, pool=3), 5, torch.device('cpu'))\n"
            "    s.setup(); s.quiesce(); s.window(0.2); s.free_program(); s.check()\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_by_name(cell):
    c = cells.load_cell(cell)
    assert c.family.build_model and c.reference.specs and c.driver.window
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))


# the flagship's cells, kept ready while its steps and requests are paced by the host
@pytest.mark.parametrize("cell", ["gm128k3.train_f32_b16", "gm128k3.serve_bf16_kodak24"])
def test_waiting_cells_find_their_parts_by_name(cell):
    from port_bench.tests.tiny import bench_with

    c = cells.load_cell(cell, bench_with(cell))
    assert c.family.build_model and c.reference.specs and c.driver.window
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for name in (f"{c.unit}_host_ms", f"{c.unit}_mfu", f"conv_ms.{c.unit}", f"idle_pct.{c.unit}"):
        assert callable(cells.metric_reader(name))


def test_new_config_mix_kind_and_metrics_are_found_without_editing_the_harness(tmp_path):
    root = tmp_path / "port_bench"
    for sub in ("configs", "mixes", "limits", "metrics", "drivers"):
        (root / sub).mkdir(parents=True)
    cfg = json.loads((HERE / "configs" / "gm128k3.json").read_text())
    (root / "configs" / "other.json").write_text(json.dumps(dict(cfg, name="other", K=1)))
    mix = dict(traffic.load_mix("serve_bf16_kodak24"), name="serve_f32_b1", dtype="float32",
               batch=1)
    (root / "mixes" / "serve_f32_b1.json").write_text(json.dumps(mix))
    (root / "mixes" / "codec_b1.json").write_text(json.dumps(dict(mix, kind="codec")))
    (root / "drivers" / "codec.py").write_text("def unit_name(config):\n    return 'codec'\n")
    for cell in ("other.serve_f32_b1", "other.codec_b1"):
        (root / "limits" / f"{cell}.json").write_text('{"x_hat_rel": 0.1}')
    # a per-layer metric that counts its own shapes, and an end-to-end one
    (root / "metrics" / "made_up_ms.py").write_text(
        "def read(run):\n    return run.cell.mix['batch'] * run.cell.config['K'] * 1.5\n")
    (root / "metrics" / "codec_s.py").write_text(
        "def read(run):\n    return run.window.units / run.window.seconds\n")
    bench = {"configs": [{"name": "other", "file": "port_bench/configs/other.json"}],
             "workloads": [{"name": "other.serve_f32_b1", "config": "other",
                            "traffic": "serve_f32_b1", "chips": 1},
                           {"name": "other.codec_b1", "config": "other",
                            "traffic": "codec_b1", "chips": 1}],
             "end_to_end": [{"name": "codec_s", "unit": "1/s",
                             "workloads": ["other.codec_b1"]}],
             "per_layer": [{"name": "made_up_ms", "unit": "ms"}]}
    cell = cells.load_cell("other.serve_f32_b1", bench, root)
    assert cell.config["K"] == 1 and cell.mix["batch"] == 1 and cell.unit == "serve"
    assert cell.family.__name__.endswith("joint_ar")
    run = readers.Run(cell, traffic.Window(start=0.0, end=2.0, enqueue=[(0, 1)] * 3), 9.0)
    assert cells.metric_reader("made_up_ms", root)(run) == 1.5
    codec = cells.load_cell("other.codec_b1", bench, root)
    assert codec.unit == "codec" and [m["name"] for m in codec.end_to_end] == ["codec_s"]
    assert cells.metric_reader("codec_s", root)(readers.Run(codec, run.window, 9.0)) == 1.5
    (root / "mixes" / "bad.json").write_text(json.dumps(dict(mix, kind="nothing")))
    with pytest.raises(ValueError):
        traffic.load_mix("bad", root / "mixes", root / "drivers")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(cells.metric_reader(metric))


def test_end_to_end_readers_take_the_whole_window():
    serve = cells.load_cell("scal192.serve_bf16_kodak24")
    latency = [0.010 + 0.001 * (i % 20) for i in range(100)]
    win = traffic.Window(start=0.0, end=2.0, enqueue=[(0, 1)] * 100, latency=latency)
    run = readers.Run(serve, win, 17.5)
    read = {m["name"]: cells.metric_reader(m["name"])(run) for m in serve.end_to_end}
    assert read["serve_img_s"] == pytest.approx(24 * 100 / 2.0)
    assert 1e3 * 0.028 <= read["serve_p95_ms"] <= 1e3 * 0.029 and read["setup_s"] == 17.5
    train = cells.load_cell("scal192.train_f32_b16")
    run = readers.Run(train, traffic.Window(start=1.0, end=5.0, enqueue=[(0, 1)] * 40), 20.0)
    assert cells.metric_reader("distill_steps_s")(run) == pytest.approx(10.0)
    assert cells.metric_reader("train_steps_s")(run) is None


def test_benchmark_json_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    metric_keys = {"name", "unit", "better", "bound", "source", "workloads"}
    layer_keys = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= metric_keys and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= layer_keys and "\n" not in m["layer"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_moves_a_metric_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        reported = {e["name"] for e in cells.load_cell(cell).end_to_end}
        assert m["moves"] in reported and "setup_s" in reported


def test_flops_match_hand_counts():
    # a 3x3 conv from 2 to 4 channels on a 5x7 output: 2 * 35 * 9 * 2 * 4
    assert flops._conv(5, 7, 3, 2, 4) == 5040
    assert flops._deconv(2, 3, 5, 4, 1) == 2 * 6 * 25 * 4
    assert flops._gdn(2, 2, 3) == 2 * 4 * 9
    # the flagship at 64 x 64 with M = 2, K = 1: the encoder alone
    enc = (flops._conv(32, 32, 5, 3, 2) + flops._gdn(32, 32, 2) + flops._conv(16, 16, 5, 2, 2)
           + flops._gdn(16, 16, 2) + flops._conv(8, 8, 5, 2, 2) + flops._gdn(8, 8, 2)
           + flops._conv(4, 4, 5, 2, 2))
    assert flops.joint_ar_eval_flops(2, 1, 64, 64)["encoder"] == enc == 385152
    assert flops.teacher_flops(1, 16, 16) == (2 * 64 * 36 * 3 + 2 * 16 * 9 * 2 + 2 * 2 * 16 * 2
                                              + 2 * 16 + 2 * 16 * 9 + 2 * 16 * 4
                                              + 2 * 4 * 9 * 2 * 4)


def test_gdn_bytes_match_hand_counts():
    from port_bench.families import joint_ar

    class Cell:
        unit, mix = "serve", {"batch": 2, "height": 64, "width": 64, "kind": "serve",
                              "dtype": "bfloat16"}
        config = {"latent_channels": 4, "K": 1, "transform": "conv5x5"}
        family = joint_ar

    rows = 2 * (32 * 32 + 16 * 16 + 8 * 8) * 2   # the six sites, twice each size
    assert readers.gdn_bytes(Cell, False) == 2 * rows * 4 * 2 + 6 * 4 * (16 + 4)
    assert readers.gdn_bytes(Cell, True) == 3 * rows * 4 * 2 + 6 * 8 * (16 + 4)


def test_idle_share_counts_overlapping_intervals_once():
    ops = [("a", 0.0, 4.0), ("b", 1.0, 3.0), ("c", 2.0, 6.0), ("d", 8.0, 9.0), ("e", 9.5, 12.0)]
    tr = trace.Trace((1.0, 10.0), ops)
    assert trace.busy_seconds(tr) == pytest.approx(5.0 + 1.0 + 0.5)
    assert trace.idle_gaps([(s, e) for _, s, e in ops], 1.0, 10.0) == [(6.0, 8.0), (9.0, 9.5)]
    assert tr.outside() == 2  # a starts before the window, e ends after it
    cell = cells.load_cell("scal192.serve_bf16_kodak24")
    run = readers.Run(cell, traffic.Window(), 1.0, tr, 3)
    assert readers.idle_pct(run, "serve") == pytest.approx(100 * 2.5 / 9.0)
    assert readers.idle_pct(run, "train") is None
    assert readers.idle_pct(readers.Run(cell, traffic.Window(), 1.0), "serve") is None


def test_gaps_are_labelled_by_the_harness_spans():
    tr = trace.Trace((0.0, 10.0), [("k", 0.0, 2.0), ("k", 5.0, 10.0)],
                     [("train.step", 1.0, 3.0), ("train.wait", 2.5, 4.0)])
    assert trace.longest_gaps(tr) == [("train.step", 3.0)]
    assert trace.host_label(tr, 3.5) == "train.wait" and trace.host_label(tr, 4.5) == "none"


def test_span_log_stamps_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = trace.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans("outer"):
            with record_function("inner"):
                torch.ones(8).sum()
    (_, s, e), = spans.spans
    inner = next(x for x in prof.profiler.kineto_results.events() if x.name() == "inner")
    assert s <= inner.start_ns() * 1e-9 and (inner.start_ns() + inner.duration_ns()) * 1e-9 <= e


def test_kernel_buckets():
    assert kernel_layers.is_gdn_forward("void (anonymous namespace)::gdn_rows_kernel_cluster<f>")
    assert kernel_layers.is_gdn_backward("gdn_bwd_fused_kernel<float>")
    assert kernel_layers.is_convolution("void fft2d_r2c_64x64<float>(float2*)")
    assert kernel_layers.is_convolution("sm80_xmma_wgrad_implicit_gemm")
    assert not kernel_layers.is_convolution("gmm_logp_kernel<3>")


def test_train_window_waits_only_two_behind_and_at_the_end():
    log, now = [], [0.0]

    class Event:
        def __init__(self):
            self.k = len([x for x in log if x[0] == "step"]) - 1

        def record(self):
            pass

        def synchronize(self):
            log.append(("wait", self.k))

    def step(batch, generator):
        log.append(("step", int(batch)))
        now[0] += 1.0
        return {"loss": batch}

    def clock():
        return now[0]

    win = traffic.train_window(step, torch.arange(100), None, 5.5, 0, 2, clock, Event,
                               lambda: log.append(("sync", None)))
    assert [x for x in log if x[0] == "step"] == [("step", k) for k in range(6)]
    # before step k the host has waited on step k - 2, and on nothing else
    for i, entry in enumerate(log):
        if entry[0] == "step" and entry[1] >= 2:
            assert log[i - 1] == ("wait", entry[1] - 2)
    assert [x for x in log if x[0] == "wait"] == [("wait", k) for k in range(5)]
    assert log[-1] == ("sync", None) and sum(x[0] == "sync" for x in log) == 1
    assert win.units == 6 and len(win.outputs) == 6


def test_reservoir_keeps_a_seeded_sample():
    a, b = traffic.Reservoir(3, 9), traffic.Reservoir(3, 9)
    for i in range(50):
        a.offer(i, i)
        b.offer(i, i)
    assert sorted(a.kept) == sorted(b.kept) and len(a.kept) == 3
