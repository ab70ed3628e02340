"""The plain reference against the port's CPU path at tiny widths, the
faults that must turn ``correct`` false, and the control one precision
below the configuration's, which must fail a limit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pebench import control as C
from pebench import run as R
from pebench.faults import FAULTS
from pebench.reference import rope as ref_rope
from pebench.reference import schedule as ref_schedule
from pebench.tests.conftest import tiny_bench


def test_schedule_is_the_ports_bit_for_bit():
    from physicedit_torch.sampling import flow_match as fm

    want = fm.build_schedule(40, fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=4096)
    sig, nxt, ts = ref_schedule.schedule(40, 4096)
    for a, b in ((sig, want.sigmas), (nxt, want.sigmas_next), (ts, want.timesteps)):
        assert np.array_equal(a, b)
    assert ref_schedule.adapter_t_range() == fm.adapter_t_range()


def test_rope_tables_are_the_ports():
    from physicedit_torch.ops import rope as m_rope

    shapes = [(1, 64, 64), (1, 64, 64)]
    for a, b in zip(ref_rope.tables(shapes, 640), m_rope.build_rope_tables(shapes, 640)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["cell-tiny-bf16", "cell-tiny-w4"])
def test_a_fault_in_the_timed_path_turns_correct_false(tiny_root, fault, cell):
    with FAULTS[fault]():
        res = R.run_cell(tiny_bench(), cell, 2**32 + 11, 0.2, False, device="cpu",
                         root=tiny_root)
    assert res["correct"] is False, res["checks"]
    failing = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert failing, res["checks"]


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("cell", ["cell-tiny-bf16", "cell-tiny-w4"])
def test_the_control_fails_a_limit(tiny_root, cell, seed):
    """The reference computed one precision below the configuration's (fp8
    for bf16; int4 activations and fp8 elsewhere for W4A8) in the program's
    place reads above a limit; the program on the same seed below all."""
    bench = tiny_bench()
    (rec,) = C.control_run(bench, cell, [seed], {seed}, device="cpu", root=tiny_root)
    cfg, _, _ = R.cell_files(bench, R.find_cell(bench, cell), tiny_root)
    lim = cfg["limits"]
    assert all(rec["program"][k] <= lim[k] for k in lim if k in rec["program"])
    assert rec["correct"] is True and rec["failed"] == 0
    assert any(rec["control"][k] > lim[k] for k in lim if k in rec["control"])
    assert rec["control"]["dit_rel"] > 3 * rec["program"]["dit_rel"]


@pytest.mark.cuda
def test_half_batch_fails_the_limits_on_the_card():
    """At the cells' own size on the card: with half the CFG batch left out,
    each cell's check reads above one of its limits (one seed each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = R.load_bench()
    for cell in bench["workloads"]:
        (rec,) = C.control_run(bench, cell["name"], [2**31 + 19], set(), fault="half_batch")
        assert rec["correct"] is False, rec["program"]


@pytest.mark.cuda
def test_controls_fail_the_limits_on_the_card():
    """At the cells' own size on the card: each cell's control reads above
    one of its limits, the program below all (one seed each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = R.load_bench()
    for cell in bench["workloads"]:
        (rec,) = C.control_run(bench, cell["name"], [2**31 + 17], {2**31 + 17})
        cfg, _, _ = R.cell_files(bench, cell)
        lim = cfg["limits"]
        assert all(rec["program"][k] <= lim[k] for k in lim if k in rec["program"])
        assert any(rec["control"][k] > lim[k] for k in lim if k in rec["control"])
