"""repro_torch's Table 4 experiment (``examples/train_ctr_tower.py``)
against ``benchmarks/bench_ttl_ne.run``, on the CPU.

Both packages get the same click world, stream and starting projection
(the JAX package's ``eye + 0.01 N(0, 1)`` draw from ``PRNGKey(0)``, handed
to the port as ``w0``). XLA and torch sum the tower's float32 products in
different orders, so the trained weights differ by float rounding.
Tolerance: each arm's NE within a relative 1e-5 of the reference's, and
each ``ne_diff_pct`` within 1e-4 percentage points (the paper's
differences are 1e-3 to 6e-2 points).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_ttl_ne  # noqa: E402
from benchmarks.common import Report as JReport  # noqa: E402
from repro.data.clickstream import ClickWorld as JWorld  # noqa: E402
from repro_torch.examples import train_ctr_tower as ex  # noqa: E402

NE_RTOL = 1e-5
DIFF_ATOL = 1e-4                    # percentage points
SMALL = dict(n_users=300, horizon_h=3.0)


@pytest.fixture(scope="module")
def both_runs():
    dim = 16
    w0 = np.asarray(jnp.eye(dim) + 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (dim, dim)))
    j_report, t_report = JReport(), ex.Report()
    want = bench_ttl_ne.run(j_report, **SMALL)
    got = ex.run(t_report, **SMALL, w0=torch.tensor(w0), device="cpu")
    return want, got, j_report, t_report


def test_table4_matches_reference(both_runs):
    want, got, _, _ = both_runs
    assert list(got) == list(want)
    assert ex.TTLS_MIN == bench_ttl_ne.TTLS_MIN
    assert ex.PAPER == bench_ttl_ne.PAPER
    ne_fresh = {v["ne_fresh"] for v in got.values()}
    assert len(ne_fresh) == 1
    # the reference reports its fresh arm's NE to 4 decimals only
    j_fresh = float(both_runs[2].rows[0][2].split("ne_fresh=")[1]
                    .rstrip(")"))
    assert ne_fresh.pop() == pytest.approx(j_fresh, abs=5e-5)
    for label, w in want.items():
        g = got[label]
        assert g["paper"] == w["paper"]
        assert g["ne_diff_pct"] == pytest.approx(w["ne_diff_pct"],
                                                 abs=DIFF_ATOL), label
        # the reference's NE of the arm, recovered from its diff
        ne_arm = (1 + w["ne_diff_pct"] / 100) * g["ne_fresh"]
        assert g["ne"] == pytest.approx(ne_arm, rel=NE_RTOL), label


def test_report_rows_match_reference_format(both_runs):
    _, _, j_report, t_report = both_runs
    assert [r[0] for r in t_report.rows] == [r[0] for r in j_report.rows]
    paper = lambda d: d.split("paper=")[1].split("%")[0]
    for (_, us_t, d_t), (_, us_j, d_j) in zip(t_report.rows, j_report.rows):
        assert us_t == us_j == 0.0
        assert d_t.startswith("ne_diff=") and paper(d_t) == paper(d_j)


def test_world_defaults_are_the_reference():
    from repro_torch.data.clickstream import ClickWorld
    assert ClickWorld() == ClickWorld(**vars(JWorld()))


def test_default_start_is_seeded():
    a, b = ex.initial_w(16), ex.initial_w(16)
    assert torch.equal(a, b)
    assert torch.allclose(a, torch.eye(16), atol=0.1)
    assert not torch.equal(a, ex.initial_w(16, seed=1))


def test_main_on_cpu(capsys):
    out = ex.main(["--users", "200", "--hours", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:6]] == list(out)
    assert all(np.isfinite(v["ne_diff_pct"]) for v in out.values())
