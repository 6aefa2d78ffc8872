"""The trainer's global-norm clip in the port, on the CPU: the gradient
norm's plain version (`kernels/grad_norm/ref.py`), masked Adam with the
clip fused in (`masked_adam_3d(..., gn=, clip=)`, whose CPU route is
`clip_ref` + `masked_adam_ref`), `FlatMaskedAdam.step(gn=, clip=)` and the
clipped train step, against the JAX trainer's own expressions
(`src/repro/launch/train.py:53-70`).

Tolerances:

* the norm: within 1e-6 relative of the JAX expression in float32 (the
  two sum in different orders; measured gaps are a few float32 ulps);
* the clip and the Adam step given the same norm: bit for bit, also
  against the trainer's former per-leaf clip (`_former_clip_grads_`) at
  clip 1.0. At another clip the former clip's ``clip / x`` (PyTorch's
  ``__rtruediv__``: a reciprocal, then a product) may round the scale
  one float32 ulp away from the true division that JAX and the kernel
  take, so there it is held within one ulp of g's dtype;
* one Gemma 2B smoke-config train step with the clip active against the
  JAX trainer's step, float64 weights: the loss within 1e-6 relative and
  the clipped gradients within 1e-4 relative plus 1e-5 of a leaf's
  largest |value| (`tests/test_torch_train.py`'s tolerances); the
  updates u within 1e-6 relative plus 1e-5 of their largest |value|, and
  the params within 1e-6 relative plus 1e-5 of lr (the first Adam step's
  u = bc m / sqrt(v + eps) turns a gradient's roundoff into a relative
  change of up to ~1e-4 where |g| is near sqrt(eps): measured 1.5e-9
  absolute there);
* the meta trace of Gemma 2B's clipped train step (full size, 1 x 64
  tokens): its peak no larger than that of the former unfused step (both
  45,178,406,912 bytes: the peak is backward's), and the clip and Adam
  alone under 1 MiB of temporaries where the former clip took at least a
  float32 copy of the largest leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as get_smoke_jax
from repro.core import selection as selection_jax
from repro.core.masked_adam import init_state as init_state_jax
from repro.core.masked_adam import masked_adam_update as masked_adam_update_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.device import H100_SMS
from repro_torch.kernels.grad_norm import ops as gnorm_ops
from repro_torch.kernels.grad_norm.ref import grad_norm_ref
from repro_torch.kernels.masked_adam import ops as adam_ops
from repro_torch.kernels.masked_adam.ref import clip_ref, masked_adam_ref
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build, params_from_numpy
from repro_torch.roofline import analysis
from test_torch_llm import conditioned

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _bufs(seed, dtypes=(torch.bfloat16, torch.float32, torch.float16), rows=(40, 7, 3),
          scale=1.0, bad=()):
    """Gradient buffers (1, rows, 128) drawn with numpy, each rounded to
    its dtype; ``bad`` lists (buffer, flat index, value) to plant."""
    rng = np.random.default_rng(seed)
    out = []
    for r, dt in zip(rows, dtypes):
        x = torch.from_numpy(rng.normal(size=(1, r, 128)).astype(np.float32) * scale).to(dt)
        out.append(x)
    for j, i, v in bad:
        out[j].view(-1)[i] = v
    return out


def _to_jax(t):
    return jnp.asarray(t.to(torch.float32).numpy()).astype(_JNP[t.dtype])


def _jax_norm(bufs):
    return jnp.sqrt(sum(jnp.sum(jnp.square(_to_jax(g).astype(jnp.float32))) for g in bufs))


def _jax_clip(g, gn, clip):
    """The JAX trainer's clip of one leaf given the global norm."""
    gn = jnp.asarray(gn)
    scale = jnp.minimum(1.0, clip / jnp.maximum(gn, 1e-9))
    ok = jnp.isfinite(gn)
    gj = _to_jax(g)
    out = jnp.where(ok & jnp.isfinite(gj), gj.astype(jnp.float32) * scale, 0.0).astype(gj.dtype)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(g.dtype)


def _former_clip_grads_(grads, clip):
    """The trainer's clip before the gradient-norm kernel (plain torch,
    per leaf, in place): kept here to hold the fused clip to it."""
    leaves = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    ok = torch.isfinite(gn)
    with torch.no_grad():
        for g in leaves:
            g.copy_(torch.where(ok & torch.isfinite(g), g.to(torch.float32) * scale,
                                0.0).to(g.dtype))
    return gn


def _bits(t):
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# The norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 40.0)])
def test_plain_norm_matches_the_jax_expression(seed, scale):
    bufs = _bufs(seed, scale=scale)
    got = gnorm_ops.grad_norm(bufs)
    want = np.float32(_jax_norm(bufs))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    truth = np.sqrt(sum(np.sum(np.square(b.to(torch.float64).numpy())) for b in bufs))
    np.testing.assert_allclose(float(got), truth, rtol=1e-6)


@pytest.mark.parametrize("bad,check", [((0, 9, float("inf")), np.isinf),
                                       ((1, 100, float("nan")), np.isnan),
                                       ((2, 0, -float("inf")), np.isinf)])
def test_plain_norm_of_non_finite_gradients(bad, check):
    bufs = _bufs(3, bad=[bad])
    assert check(float(gnorm_ops.grad_norm(bufs))) and check(float(_jax_norm(bufs)))


def test_flat_state_norm_is_the_norm_of_its_gradients():
    rng = np.random.default_rng(4)
    params = {"a": torch.zeros(300, 7, dtype=torch.bfloat16), "b": torch.zeros(1001)}
    st = FlatMaskedAdam(params)
    with torch.no_grad():
        for g in tree.leaves(st.grads):
            g.copy_(torch.from_numpy(rng.normal(size=g.shape).astype(np.float32)))
    n0 = gnorm_ops.launches
    want = _jax_norm(tree.leaves(st.grads))
    np.testing.assert_allclose(float(st.grad_norm()), float(want), rtol=1e-6)
    assert gnorm_ops.launches == n0  # the plain version: no launch


@pytest.mark.parametrize("kw", [dict(clip=1.0), dict(gn=1.0), dict(gn=1.0, clip=0.0)])
def test_a_norm_without_a_clip_or_a_clip_without_a_norm_raises(kw):
    """A norm with clip 0 would scale every gradient by 0 / gn; a clip
    without a norm would not clip: both raise, and nothing is written."""
    st = FlatMaskedAdam({"a": torch.ones(300, 7), "b": torch.ones(1001, dtype=torch.bfloat16)})
    for g in st.g:
        g.fill_(3.0)
    if "gn" in kw:
        kw["gn"] = torch.tensor(kw["gn"])
    with pytest.raises(ValueError, match="go together"):
        st.step(lr=1e-3, **kw)
    assert all(bool((g == 3.0).all()) for g in st.g) and int(st.count) == 0
    assert all(bool((u == 0).all()) for u in st.u)


# ---------------------------------------------------------------------------
# The clip fused into masked Adam (the plain route), given the same norm
# ---------------------------------------------------------------------------

CLIP_CASES = {  # gradient scale, planted non-finite values, norm override
    "over": (5.0, (), None),
    "under": (1e-4, (), None),
    "nonfinite_g": (1.0, ((0, 3, float("inf")), (0, 700, float("nan")),
                          (1, 5, -float("inf"))), "finite"),
    "nan_norm": (1.0, (), float("nan")),
    "inf_norm": (1.0, (), float("inf")),
}


@pytest.mark.parametrize("case", list(CLIP_CASES))
@pytest.mark.parametrize("clip", [1.0, 0.7])
def test_fused_clip_and_adam_equal_the_jax_clip_then_adam(case, clip):
    scale, bad, gn_over = CLIP_CASES[case]
    grads = _bufs(5, scale=scale, bad=bad)
    if gn_over is None:
        gn = grad_norm_ref(grads)
    elif gn_over == "finite":  # the norm the finite entries would give
        gn = grad_norm_ref([torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                            for g in grads])
    else:
        gn = torch.tensor(gn_over, dtype=torch.float32)
    if case == "over":
        assert float(gn) > clip
    if case == "under":
        assert float(gn) < clip
    rng = np.random.default_rng(6)
    _, bc = adam_ops.bias_correction(torch.tensor([4], dtype=torch.int32), lr=1e-3,
                                     b1=0.9, b2=0.999)
    former = [g.clone() for g in grads]
    former_gn = _former_clip_grads_(former, clip)
    for j, g in enumerate(grads):
        p = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32)).to(g.dtype)
        m = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32) * 1e-2).to(g.dtype)
        v = torch.from_numpy(rng.random(size=g.shape).astype(np.float32) * 1e-3)
        mask = torch.from_numpy(rng.random(size=g.shape) < 0.3)
        want_g = _jax_clip(g, np.float32(gn), clip)
        want = masked_adam_ref(p, want_g, m, v, mask, bc, **ADAM)
        u = torch.empty(p.shape)
        out = adam_ops.masked_adam_3d(p, g, m, v, mask, bc, **ADAM, out=(p, m, v, u), gn=gn,
                                      clip=clip)
        assert out[0] is p and out[3] is u
        for got, ref in zip((g, p, m, v, u), (want_g, *want)):
            assert got.dtype == ref.dtype and torch.equal(_bits(got), _bits(ref))
        if case in ("nan_norm", "inf_norm"):
            assert not bool(g.any())
        if gn_over is not None or clip != 1.0:
            continue
        # the former per-leaf clip, given its own (equal) norm, at clip 1.0
        assert torch.equal(former_gn, gn)
        assert torch.equal(_bits(former[j]), _bits(g))


@pytest.mark.parametrize("seed", range(4))
def test_former_clip_within_one_ulp_at_another_clip(seed):
    """At clip 0.7 the former clip's reciprocal-then-product scale is at
    most one float32 ulp off the true division; the clipped gradients are
    within one ulp of their dtype."""
    grads = _bufs(10 + seed, scale=3.0)
    gn = grad_norm_ref(grads)
    former = [g.clone() for g in grads]
    _former_clip_grads_(former, 0.7)
    for g, f in zip(grads, former):
        got = clip_ref(g, gn, 0.7).to(torch.float32)
        ulp = torch.finfo(g.dtype).eps * got.abs().clamp(min=torch.finfo(g.dtype).tiny)
        assert bool(((got - f.to(torch.float32)).abs() <= ulp).all())


# ---------------------------------------------------------------------------
# The clipped train step against the JAX trainer's
# ---------------------------------------------------------------------------


def test_clipped_train_step_matches_the_jax_trainer_step():
    """One Gemma 2B smoke-config step, float64 weights, the clip at 3.0,
    under the step's global norm (13.87), so it scales every gradient:
    the clipped gradients' norm is the clip."""
    dtype, lr, b, s, clip = "float64", 1e-3, 2, 16, 3.0
    cfg_j = get_smoke_jax("gemma-2b", param_dtype=dtype, compute_dtype=dtype)
    with jax.enable_x64(True):
        model_j = build_jax(cfg_j)
        pj = conditioned(cfg_j, build_jax(get_smoke_jax("gemma-2b")).init(
            jax.random.PRNGKey(0)))
        pn = jax.tree.map(lambda a: np.asarray(a).astype(dtype), pj)
        params = jax.tree.map(jnp.asarray, pn)
        mask = selection_jax.random_mask(jax.random.PRNGKey(3), params, 0.05)
        toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (b, s + 1)).astype(np.int32)
        batch_j = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
        @jax.jit
        def step(params, opt, mask, batch):  # the JAX trainer's step
            (loss, _), grads = jax.value_and_grad(model_j.loss, has_aux=True)(params, batch)
            gn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                              for g in jax.tree.leaves(grads)))
            scale = jnp.minimum(1.0, clip / jnp.maximum(gn, 1e-9))
            ok = jnp.isfinite(gn)
            grads = jax.tree.map(lambda g: jnp.where(ok & jnp.isfinite(g),
                                                     g.astype(jnp.float32) * scale,
                                                     0.0).astype(g.dtype), grads)
            params, opt, u = masked_adam_update_jax(params, grads, opt, mask, lr=lr)
            return params, grads, u, loss

        p_new, grads, u_j, loss_j = step(params, init_state_jax(params), mask, batch_j)
        want_p, want_g, want_u = (jax.tree.map(np.asarray, t) for t in (p_new, grads, u_j))

    cfg = get_smoke("gemma-2b", param_dtype=dtype, compute_dtype=dtype)
    st = FlatMaskedAdam(params_from_numpy(pn, device="cpu"))
    st.set_mask(params_from_numpy(jax.tree.map(np.asarray, mask), device="cpu"))
    u, loss = make_train_step(build(cfg), lr=lr, clip=clip)(
        st, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(float(grad_norm_ref(st.g)), clip, rtol=1e-5)
    leaves = list(zip(tree.leaves(st.grads), tree.leaves(st.params), tree.leaves(u)))
    assert len(leaves) == len(jax.tree.leaves(want_g))
    for (g, p, uu), wg, wp, wu in zip(leaves, jax.tree.leaves(want_g),
                                      jax.tree.leaves(want_p), jax.tree.leaves(want_u)):
        np.testing.assert_allclose(g.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(wg).max()) + 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), wp, rtol=1e-6, atol=1e-5 * lr)
        np.testing.assert_allclose(uu.numpy(), wu, rtol=1e-6,
                                   atol=1e-5 * float(np.abs(wu).max()))


def test_meta_trace_of_the_clipped_step_peaks_no_higher_than_the_unfused_one():
    """Gemma 2B at full size, 1 x 64 tokens, bf16 first moments (the
    trainer's state on the card), on the meta device: the fused step
    (norm kernel, clip inside K1) against the former step (per-leaf
    float32 clip, then K1)."""
    cfg = get_config("gemma-2b")
    model = build(cfg)

    def unfused(state, batch):
        state.zero_grad()
        loss, _ = model.loss(state.params, batch)
        loss.backward()
        _former_clip_grads_(state.grads, 1.0)
        state.step(lr=1e-3)
        return state.u_tree, loss.detach()

    def clip_and_adam(state):
        state.step(lr=1e-3, gn=state.grad_norm(), clip=1.0)
        return state.u_tree

    def former_clip_and_adam(state):
        _former_clip_grads_(state.grads, 1.0)
        state.step(lr=1e-3)
        return state.u_tree

    peaks, temps = {}, {}
    for name, step, opt in (("fused", make_train_step(model, clip=1.0), clip_and_adam),
                            ("unfused", unfused, former_clip_and_adam)):
        state = FlatMaskedAdam(model.abstract(), m_dtype=torch.bfloat16)
        peaks[name] = analysis.trace_facts(step, state, ispec.train_inputs(cfg, 1, 64))[
            "peak_bytes"]
        f = analysis.trace_facts(opt, state)
        temps[name] = f["peak_bytes"] - f["arg_bytes"]
        del state
    # the step's peak is backward's; the clip and Adam alone: the norm's
    # workspace and result against float32 copies of the largest leaf
    assert peaks["fused"] <= peaks["unfused"], peaks
    largest = max(l.numel() for l in tree.leaves(model.abstract()))
    assert temps["fused"] < 1 << 20 and temps["unfused"] >= 4 * largest, temps


# ---------------------------------------------------------------------------
# The kernels' launch shapes (host-side logic of the card's route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vecs,want", [
    (41_808, (64, 654)),                # B = 1 of the width-4.0 student: one vector a thread
    (8 * 41_808, (64, 1_056)),          # B = 8: 132 SMs x 512 threads, strided
    (313_271_552, (64, 4_894_868)),     # Gemma 2B's step: one vector a thread
    (1, (64, 1)),
])
def test_masked_adam_launch_shape_on_an_h100(vecs, want):
    assert adam_ops.launch_shape(vecs, 132) == want


@pytest.mark.parametrize("vecs,want", [(1, 1), (41_808, 164), (313_271_552, 528)])
def test_grad_norm_grid_on_an_h100(vecs, want):
    assert gnorm_ops.launch_blocks(vecs, 132) == want


def test_grad_norm_meta_branch_allocates_the_cuda_routes_workspace():
    bufs = [torch.empty((1, 4096, 128), dtype=torch.bfloat16, device="meta"),
            torch.empty((1, 300, 128), device="meta")]
    f = analysis.trace_facts(gnorm_ops.grad_norm, bufs)
    blocks = gnorm_ops.launch_blocks((4096 + 300) * 16, H100_SMS)
    assert f["out"].shape == () and f["out"].dtype == torch.float32
    assert f["peak_bytes"] - f["arg_bytes"] == 512 * (-(-8 * (blocks + 1) // 512) + 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        gnorm_ops.grad_norm([torch.empty(12, device="meta")])
    with pytest.raises(ValueError, match="1 to 8"):
        gnorm_ops.grad_norm([torch.empty(8, device="meta")] * 9)
