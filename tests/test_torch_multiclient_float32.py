"""Port parity for the multi-client simulation with the students' own
float32 loss, and for ``train_phases_fused(force_stack=True)`` at B = 3,
against the JAX package on the CPU. The setting and the helpers are
`tests/test_torch_multiclient.py`'s.

* float32 (ROADMAP F5): mean mIoU within 0.02, the same phases per client
  and the same fused launches.
* ``force_stack=True`` (the JAX package's `tests/test_update_pipeline.py`
  case): the first phase (random masks) encodes as one batch, the second
  selects as one stacked launch; counters as the JAX package's, wire masks
  byte-identical and fp16 values within 1 ULP (float64 gradients).
"""
import jax
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import selection as jsel
from repro_torch.core import batched as tbatched
from repro_torch.core import selection as tsel
from test_torch_multiclient import (_j_init, _jax_run, _np, _port_run,
                                    _replaying, _sessions, _ulps, pin_loop)


@pytest.fixture(scope="module")
def runs32():
    torch.set_num_threads(1)
    j, masks, p0, _, _ = _jax_run(False)
    t, _, _ = _port_run(False, masks, p0)
    return dict(j=j, t=t)


def test_float32_mean_miou(runs32):
    j, t = runs32["j"], runs32["t"]
    assert t["phases_per_client"] == j["phases_per_client"]
    assert t["fused_launches"] == j["fused_launches"] > 0
    assert abs(t["mean_miou"] - j["mean_miou"]) <= 0.02, (t["mean_miou"],
                                                          j["mean_miou"])


def test_force_stack_batches_select_and_encode():
    """``force_stack=True``: the first phase (random masks) encodes as one
    batch, the second selects as one stacked launch; counters, stage keys
    and wire bytes as the JAX package's (float64 gradients)."""
    p0, n = _j_init(), 3
    masks, draw = [], jsel.random_mask

    def recording(*args, **kw):
        m = draw(*args, **kw)
        masks.append(_np(m))
        return m

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsel, "random_mask", recording)
        pin_loop(mp)
        js = _sessions("jax", n, p0, True)
        jbatched.update_pipeline_reset()
        j_out = [jbatched.train_phases_fused(js, t, force_stack=True)
                 for t in (6.0, 14.0)]
        j_info = jbatched.update_pipeline_info()
    replay, left = _replaying(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsel, "random_mask", replay)
        ts = _sessions("torch", n, p0, True)
        tbatched.update_pipeline_reset()
        t_out = [tbatched.train_phases_fused(ts, t, force_stack=True)
                 for t in (6.0, 14.0)]
    assert next(left, None) is None
    assert tbatched.update_pipeline_info() == j_info == {
        "stacked_select_launches": 1, "stacked_select_sessions": n,
        "stacked_encode_launches": 2, "stacked_encode_sessions": 2 * n}
    for jd, td in zip(sum(j_out, []), sum(t_out, [])):
        assert td.packed_mask == jd.packed_mask
        assert td.value_dtype == "float16"
        assert _ulps(td.values, jd.values).max() <= 1
    assert all(s.phase == 2 for s in ts)
