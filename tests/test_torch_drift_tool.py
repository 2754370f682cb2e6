"""tools/exact_copy_drift.py on the CPU at a tiny size.

The traced loop is the demo's: its first epochs equal ``train/classical.py:
run`` on the same exact-copy pair bit for bit; a ``--plain`` trace equals the
default one; the module attributes the tracer patches are restored; and on
the slot points the trace keeps, the JAX package's stage 2 and the port's
give the same median, loss (1e-6 relative) and gradient (1e-5 relative L2).
"""

import importlib.util
import os

import numpy as np

from a_robust_registration_loss_tpu_torch.ops import metric as M
from a_robust_registration_loss_tpu_torch.train import classical as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "exact_copy_drift", os.path.join(ROOT, "tools", "exact_copy_drift.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)

SMALL = ["--device", "cpu", "--n", "256", "--n_lines", "400", "--num_sample", "256",
         "--epochs", "8", "--threads", "2"]


def test_trace_is_the_demo_loop_and_stage2_matches_jax(tmp_path):
    import chip_smoke as CS

    stage2, update = M.stage2, C.adam_update
    a = TOOL.main(["run", "--out", str(tmp_path / "a.npz")] + SMALL)
    assert M.stage2 is stage2 and C.adam_update is update  # patches restored
    TOOL.main(["run", "--out", str(tmp_path / "b.npz"), "--plain"] + SMALL)
    assert TOOL.main(["compare", str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]) is None

    src, tar = CS.synthetic_pairs(1, 256, exact=True)
    cfg = C.ClassicalConfig(n_epochs=8, n_lines=400, num_sample=256, log_every=4)
    params, hist = C.run(src[0], tar[0], cfg, device="cpu")
    np.testing.assert_array_equal(a["twist"][-1], params.numpy())
    np.testing.assert_array_equal(a["loss"], hist["loss"])
    np.testing.assert_array_equal(a["chamfer"], hist["chamfer"])
    assert np.isfinite(a["median"]).all() and (a["median"] > 0).all()

    got = TOOL.main(["jax", str(tmp_path / "a.npz")])
    assert set(got) == {"before", "spike"}
    for r in got.values():
        assert r["jax_median"] == a["median"][r["epoch"]]
        assert abs(r["port_loss"] - r["jax_loss"]) <= 1e-6 * abs(r["jax_loss"])
        assert abs(r["port_loss"] - a["loss"][r["epoch"]]) <= 1e-6 * abs(r["jax_loss"])
        assert r["grad_rel_l2"] <= 1e-5
