"""The port's MoE layer (`models/moe.py`) against the JAX package's, on
the Moonlight-16B-A3B smoke config (4 experts top-2, a shared expert,
SwiGLU) and Mixtral's (no shared expert): the same parameters (the JAX
package's init, carried over with `params_from_numpy`) and the same
inputs, drawn with numpy from a seed.

Held: the router's expert ids, and the slots' positions and keep mask,
identical to the JAX package's at capacity 1.0, where slots are dropped;
the outputs and the aux loss within `tests/test_torch_llm.py`'s float32
tolerances (rtol 1e-4, atol 1e-5 + 1e-4 of the largest |value|). At
capacity 4.0 (>= E/k, so nothing drops) both packages' `moe_apply` equal
their dense oracles `moe_ref`. bfloat16 is held in relative L2 norm
(2e-2), as the LLM tests hold it.

The router's top-k runs in float32 in both packages, and the two can
order near-equal probabilities differently. Each test first asserts that
its data's k-th and (k+1)-th probabilities are further apart than the
two frameworks' rounding, so that a mismatch of ids or positions is a
bug of the port, not a tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as get_smoke_jax
from repro.models import moe as moe_jax
from repro.models.common import init_params as init_params_jax
from repro_torch.configs import get_smoke
from repro_torch.models import moe
from repro_torch.models.common import params_from_numpy

RTOL, ATOL, SCALE_ATOL = 1e-4, 1e-5, 1e-4
TIE_GAP = 1e-5  # far above float32 softmax rounding (~1e-7)


def _setup(arch, cap, dtype=jnp.float32, shape=(2, 32)):
    cfg_j = get_smoke_jax(arch).replace(capacity_factor=cap)
    cfg_t = get_smoke(arch).replace(capacity_factor=cap)
    params_j = init_params_jax(moe_jax.moe_metas(cfg_j), jax.random.PRNGKey(0), dtype)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    x = np.random.default_rng(3).normal(size=shape + (cfg_t.d_model,)).astype(np.float32)
    x_j = jnp.asarray(x, dtype)
    x_t = params_from_numpy(np.asarray(x_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t, x_j, x_t


def _close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL + SCALE_ATOL * float(np.abs(want).max()))


def _jax_positions(cfg, idx):
    """Slot positions and keep flags of expert ids idx (T, k), by
    `moe_apply`'s cumulative count in the JAX package."""
    T, k = idx.shape
    E = cfg.num_experts
    cap = min(max(int(cfg.capacity_factor * T * k / E), 1), T)
    idx_f = jnp.asarray(idx).reshape(T * k)
    one_hot = (idx_f[:, None] == jnp.arange(E)[None, :]).astype(jnp.int32)
    pos_f = (jnp.cumsum(one_hot, axis=0) * one_hot).sum(axis=-1) - 1
    return np.asarray(pos_f), np.asarray(pos_f < cap)


def _jax_dispatch(cfg, params, x):
    """The JAX package's routing and slot positions, by its own code
    (`_route`, then `moe_apply`'s cumulative count)."""
    T = x.shape[0] * x.shape[1]
    x_flat = x.reshape(T, cfg.d_model)
    _, idx, _ = moe_jax._route(cfg, params, x_flat)
    probs = jax.nn.softmax((x_flat @ params["router"]).astype(jnp.float32), axis=-1)
    pos_f, keep = _jax_positions(cfg, idx)
    return np.asarray(idx), pos_f, keep, np.asarray(probs)


def _assert_no_near_ties(probs, k):
    top = np.sort(probs, axis=-1)[:, ::-1]
    gaps = top[:, :k] - top[:, 1:k + 1]  # consecutive gaps through the (k+1)-th
    assert gaps.min() > TIE_GAP, gaps.min()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_dispatch_and_output_match_jax_with_drops(arch):
    cfg_j, cfg_t, params_j, params_t, x_j, x_t = _setup(arch, cap=1.0)
    idx_j, pos_j, keep_j, probs = _jax_dispatch(cfg_j, params_j, x_j)
    _assert_no_near_ties(probs, cfg_t.experts_per_token)
    _, idx_t, _ = moe._route(cfg_t, params_t, x_t.reshape(-1, cfg_t.d_model))
    pos_t, keep_t = moe.dispatch(cfg_t, idx_t)
    assert np.array_equal(idx_t.numpy(), idx_j)
    assert np.array_equal(pos_t.numpy(), pos_j)
    assert np.array_equal(keep_t.numpy(), keep_j)
    assert 0 < (~keep_j).sum() < keep_j.size  # drops happen, and not everywhere

    want, aux_j = moe_jax.moe_apply(cfg_j, params_j, x_j)
    got, aux_t = moe.moe_apply(cfg_t, params_t, x_t)
    assert got.shape == x_t.shape and aux_t.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=RTOL, atol=ATOL)


def test_capacity_is_the_reference_formula():
    cfg = get_smoke("moonshot-v1-16b-a3b")
    for T in (1, 2, 3, 7, 64, 1000):
        for cf in (0.1, 1.0, 1.25, 4.0):
            c = cfg.replace(capacity_factor=cf)
            want = min(max(int(cf * T * c.experts_per_token / c.num_experts), 1), T)
            assert moe.capacity(c, T) == want


def test_decode_shape_drops_a_shared_expert():
    """A decode step of B = 2 has cap = 1: when both tokens pick one expert,
    the second token's slot there is dropped, as in the JAX package."""
    cfg_j, cfg_t, params_j, params_t, x_j, x_t = _setup("moonshot-v1-16b-a3b", 1.25,
                                                       shape=(2, 1))
    assert moe.capacity(cfg_t, 2) == 1
    idx_j, pos_j, keep_j, probs = _jax_dispatch(cfg_j, params_j, x_j)
    _assert_no_near_ties(probs, cfg_t.experts_per_token)
    _, idx_t, _ = moe._route(cfg_t, params_t, x_t.reshape(-1, cfg_t.d_model))
    pos_t, keep_t = moe.dispatch(cfg_t, idx_t)
    assert np.array_equal(pos_t.numpy(), pos_j) and np.array_equal(keep_t.numpy(), keep_j)
    shared = set(idx_j[0]) & set(idx_j[1])
    assert (~keep_j).sum() == len(shared)
    want, _ = moe_jax.moe_apply(cfg_j, params_j, x_j)
    got, _ = moe.moe_apply(cfg_t, params_t, x_t)
    _close(got, want)


@pytest.mark.parametrize("sizes", [(5, 7, 3), (0, 9, 4, 2), (11, 1, 6)])
def test_shard_positions_are_one_dispatch_over_all_tokens(sizes):
    """The sharded dispatch's functions on one process. Each shard of the
    tokens (per-shard T that do not divide evenly, one empty) takes
    `dispatch` with the lower shards' `expert_counts` as its offset and
    the capacity of all the tokens: concatenated, its positions and keep
    flags are `dispatch`'s over all the tokens, and the JAX package's.
    Each shard's capacity rows of the buffer (`_write_rows`), side by
    side, are the whole buffer bit for bit (and zeros past it); the
    shards' parts of the combine (`_combine_rows`) sum to `_combine`'s
    output. Expert ids are skewed towards two experts, so slots drop."""
    cfg = get_smoke("mixtral-8x22b")  # capacity_factor 1.25
    E, k, T, R = cfg.num_experts, cfg.experts_per_token, sum(sizes), len(sizes)
    rng = np.random.default_rng(len(sizes))
    skew = np.array([0.4, 0.3] + [0.3 / (E - 2)] * (E - 2))
    idx = torch.from_numpy(np.stack([rng.choice(E, k, replace=False, p=skew)
                                     for _ in range(T)]))
    x = torch.from_numpy(rng.normal(size=(T, 8)))
    w = torch.from_numpy(rng.uniform(size=(T, k)))
    want_pos, want_keep = moe.dispatch(cfg, idx)
    assert 0 < (~want_keep).sum() < want_keep.numel()
    jax_pos, jax_keep = _jax_positions(cfg, idx.numpy())
    assert np.array_equal(want_pos.numpy(), jax_pos)
    assert np.array_equal(want_keep.numpy(), jax_keep)

    cap = moe.capacity(cfg, T)
    offset = torch.zeros(E, dtype=torch.int32)
    pos, keep = [], []
    for part in torch.split(idx, sizes):
        p_s, k_s = moe.dispatch(cfg, part, offset, cap)
        pos.append(p_s)
        keep.append(k_s)
        offset = offset + moe.expert_counts(cfg, part)
    assert torch.equal(torch.cat(pos), want_pos)
    assert torch.equal(torch.cat(keep), want_keep)
    assert torch.equal(offset, torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32))

    buf, _, _ = moe._dispatch_tokens(cfg, x, idx)
    rows = -(-cap // R)
    parts = [moe._write_rows(cfg, r * rows, rows, x, idx, want_pos, want_keep)
             for r in range(R)]
    got = torch.cat(parts, dim=1)
    assert torch.equal(got[:, :cap], buf) and not got[:, cap:].any()
    h = torch.from_numpy(rng.normal(size=buf.shape))
    h_pad = torch.cat([h, torch.zeros((E, R * rows - cap, 8), dtype=h.dtype)], dim=1)
    out = sum(moe._combine_rows(r * rows, rows, h_pad[:, r * rows:(r + 1) * rows], idx, w,
                                want_pos, want_keep) for r in range(R))
    torch.testing.assert_close(out, moe._combine(h, idx, w, want_pos, want_keep),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_dropless_capacity_equals_the_dense_oracle(arch):
    cfg_j, cfg_t, params_j, params_t, x_j, x_t = _setup(arch, cap=4.0)
    assert moe.dispatch(cfg_t, moe._route(cfg_t, params_t, x_t.reshape(-1, cfg_t.d_model))[1])[1].all()
    got, aux_t = moe.moe_apply(cfg_t, params_t, x_t)
    ref_t, aux_ref_t = moe.moe_ref(cfg_t, params_t, x_t)
    ref_j, aux_ref_j = moe_jax.moe_ref(cfg_j, params_j, x_j)
    _close(got, ref_t)
    _close(ref_t, ref_j)
    assert float(aux_t) == float(aux_ref_t)
    np.testing.assert_allclose(float(aux_ref_t), float(aux_ref_j), rtol=RTOL, atol=ATOL)


def test_bf16_matches_jax_in_norm():
    cfg_j, cfg_t, params_j, params_t, x_j, x_t = _setup("moonshot-v1-16b-a3b", 1.25,
                                                       dtype=jnp.bfloat16)
    assert params_t["wg"].dtype == torch.bfloat16 and x_t.dtype == torch.bfloat16
    want, aux_j = moe_jax.moe_apply(cfg_j, params_j, x_j)
    got, aux_t = moe.moe_apply(cfg_t, params_t, x_t)
    assert got.dtype == torch.bfloat16 and aux_t.dtype == torch.float32
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=2e-2)


def test_kept_slots_take_distinct_buffer_rows():
    """Each kept slot has its own (expert, position) row below cap, and an
    expert's positions count 0, 1, ... in slot order: so the port's index
    assignment of the kept slots writes what the JAX package's add into
    zeros writes (no row is written twice)."""
    _, cfg, _, params, _, x = _setup("moonshot-v1-16b-a3b", cap=1.0)
    T, k, d = 64, cfg.experts_per_token, cfg.d_model
    x_flat = x.reshape(T, d)
    _, idx, _ = moe._route(cfg, params, x_flat)
    pos, keep = moe.dispatch(cfg, idx)
    pairs = {(int(e), int(p)) for e, p, kp in zip(idx.reshape(-1), pos, keep) if kp}
    assert len(pairs) == int(keep.sum())
    cap = moe.capacity(cfg, T)
    assert all(0 <= p < cap for _, p in pairs)
    # within each expert, the kept positions are 0..n-1 in slot order
    for e in range(cfg.num_experts):
        ps = [int(p) for ee, p in zip(idx.reshape(-1), pos) if int(ee) == e]
        assert ps == list(range(len(ps)))
