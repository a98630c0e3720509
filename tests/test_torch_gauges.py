"""The port's gauge series (step.gauge_snapshot, the executor's gauge
piece, engine.collect_gauges / gauge_series / write_gauge_csv) and the
CLI's --gauge-csv and --metrics-export on the CPU, against the JAX
package's.

- `gauge_series()` equals the JAX engine's: the same sample times, the
  three counts (nodes, live pods, queued pods) exact, the four
  utilizations (float32 sums, summed in another order) at rtol 1e-6;
  on a plain trace and on the composed line with the HPA and the CA
  through a sliding pod window; gauge collection turns fast-forward off
  on both sides.
- On the stubbed capture backend the gauge piece samples what the
  uncaptured run samples, read back once a span (GAUGE_SPAN windows at
  most), not once a window.
- The CSV's header is the reference's GAUGE_CSV_COLUMNS; the CLI's
  --gauge-csv writes the JAX CLI's series (tests/test_cli.py:67);
  --metrics-export writes STEM.jsonl and STEM.prom with the recorder on
  and raises without it.
"""

import csv
import json

import numpy as np
import pytest

from test_torch_reference import build_jax_engine, build_port_engine

from kubernetriks_tpu.cli import main as jax_cli_main  # noqa: E402
from kubernetriks_tpu.metrics.collector import GAUGE_CSV_COLUMNS as REF_COLUMNS  # noqa: E402
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML  # noqa: E402
from test_cli import _write_config  # noqa: E402
from test_torch_autoscale import TOY  # noqa: E402
from test_torch_executor import stub_graphs  # noqa: E402
from test_torch_fast_forward import SparseSpec  # noqa: E402
from test_torch_telemetry import CheapSpec  # noqa: E402

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.batched.graphs import GAUGE_SPAN
from kubernetriks_tpu_torch.telemetry.gauges import GAUGE_CSV_COLUMNS


def assert_gauges_match(ref, mine):
    """(times, samples) pairs: times and the three counts exact, the
    utilizations at rtol 1e-6."""
    (tr, sr), (tm, sm) = ref, mine
    assert sm.shape == sr.shape and len(tm) > 0
    np.testing.assert_array_equal(tm, tr)
    np.testing.assert_array_equal(sm[..., :3], np.asarray(sr)[..., :3])
    np.testing.assert_allclose(sm[..., 3:], np.asarray(sr)[..., 3:], rtol=1e-6, atol=0.0)


def _gauged(sim, ends):
    sim.collect_gauges = True
    for end in ends:
        sim.step_until_time(end)
    return sim.gauge_series()


@pytest.mark.parametrize("case", ["plain", "composed_sliding", "sparse_fast_forward"])
def test_gauge_series_matches_reference(case):
    if case == "plain":
        args, kwargs, ends = (DEFAULT_TEST_CONFIG_YAML, CheapSpec(), 2, 16), {"fast_forward": False}, (150.0, 300.0)
    elif case == "composed_sliding":
        args, kwargs, ends = (TOY.config_yaml, TOY, 2, 8), {"pod_window": 8, "reclaim": True,
                                                             "fast_forward": False}, (200.0, 500.0)
    else:
        args, kwargs, ends = (DEFAULT_TEST_CONFIG_YAML, SparseSpec(), 2, 8), {"fast_forward": True}, (1000.0, 2000.0)
    jx = build_jax_engine(*args, "xla", **kwargs)
    port = build_port_engine(*args, **kwargs)
    ref, mine = _gauged(jx, ends), _gauged(port, ends)
    assert_gauges_match(ref, mine)
    # Every window sampled: gauge collection steps every window.
    assert len(mine[0]) == port.next_window_idx
    assert port.dispatch_stats["skipped_windows"] == 0
    assert mine[1][..., 0].max() > 0 and mine[1][..., 3].max() > 0


def test_gauges_on_a_stubbed_capture_read_once_a_span():
    def build():
        return build_port_engine(TOY.config_yaml, TOY, 2, 8, pod_window=8, fast_forward=False)

    plain = build()
    want = _gauged(plain, (700.0,))
    sim = stub_graphs(build())
    sim.collect_gauges = True
    sim.precompile_pieces()
    assert ("gauge",) in sim._executor.graphs
    syncs0 = sim.host_syncs
    got = _gauged(sim, (700.0,))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # One read a slide (or growth) and one gauge read a span: none a window.
    stats = sim.dispatch_stats
    assert sim.host_syncs - syncs0 == 2 * (stats["slides"] + stats["grows"]) + 1
    assert sim.next_window_idx > 2 * (stats["slides"] + stats["grows"]) + 1
    long = build_port_engine(DEFAULT_TEST_CONFIG_YAML, SparseSpec(), 1, 8, fast_forward=False)
    _gauged(long, (10.0 * (GAUGE_SPAN + 5),))
    assert long.host_syncs == 2  # one read a GAUGE_SPAN windows


def test_csv_columns_match_reference(tmp_path):
    assert GAUGE_CSV_COLUMNS == list(REF_COLUMNS)
    sim = build_port_engine(DEFAULT_TEST_CONFIG_YAML, CheapSpec(), 2, 16, fast_forward=False)
    times, samples = _gauged(sim, (100.0,))
    path = tmp_path / "g.csv"
    sim.write_gauge_csv(str(path), cluster=1)
    rows = list(csv.reader(open(path)))
    assert rows[0] == list(REF_COLUMNS) and len(rows) == len(times) + 1
    assert float(rows[-1][0]) == times[-1] and int(rows[-1][1]) == int(samples[-1, 1, 0])


def test_cli_gauge_csv_matches_reference(tmp_path, capsys):
    """tests/test_cli.py:67 on the port's CLI: two lockstep clusters, the
    gauge CSV written; its rows equal the JAX CLI's."""
    cfg = _write_config(tmp_path)
    mine, ref = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert port_cli.main(["--config-file", cfg, "--device", "cpu", "--clusters", "2", "--gauge-csv", str(mine)]) == 0
    out = capsys.readouterr().out
    assert '"pods_succeeded": 2' in out
    assert jax_cli_main(["--config-file", cfg, "--backend", "batched", "--clusters", "2",
                         "--gauge-csv", str(ref)]) == 0
    capsys.readouterr()
    got, want = list(csv.reader(open(mine))), list(csv.reader(open(ref)))
    assert got[0] == want[0] == list(REF_COLUMNS) and len(got) > 2
    assert len(got) == len(want)
    g = np.asarray(got[1:], dtype=np.float64)
    w = np.asarray(want[1:], dtype=np.float64)
    np.testing.assert_array_equal(g[:, :4], w[:, :4])
    np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=1e-6, atol=0.0)


def test_cli_metrics_export(tmp_path, capsys, monkeypatch):
    """With KTPU_TRACE=1, --metrics-export STEM writes STEM.jsonl (one
    record a ring drain) and STEM.prom, the report renders and the Chrome
    trace is written; without the recorder the export raises."""
    cfg = _write_config(tmp_path)
    stem = str(tmp_path / "metrics")
    with pytest.raises(ValueError, match="telemetry is off"):
        port_cli.main(["--config-file", cfg, "--device", "cpu", "--metrics-export", stem])
    monkeypatch.setenv("KTPU_TRACE", "1")
    monkeypatch.setenv("KTPU_TRACE_PATH", str(tmp_path / "trace"))
    assert port_cli.main(["--config-file", cfg, "--device", "cpu", "--metrics-export", stem,
                          "--report", "table"]) == 0
    out = capsys.readouterr().out
    assert "| Phase" in out and "Ring windows kept" in out
    records = [json.loads(line) for line in open(stem + ".jsonl")]
    assert records and all(r["fresh_windows"] > 0 for r in records)
    assert {"occupancy", "resources", "watchdog", "window"} <= set(records[0])
    prom = open(stem + ".prom").read().splitlines()
    assert any(line.startswith("ktpu_ring_windows_recorded ") for line in prom)
    assert any(line.startswith('ktpu_dispatch_total{kind="eager_windows"}') for line in prom)
    trace = json.load(open(tmp_path / "trace.json"))
    assert any(ev["ph"] == "X" for ev in trace["traceEvents"])
