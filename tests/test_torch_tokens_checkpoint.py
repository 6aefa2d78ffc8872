"""The port's token stream (`repro_torch.data.tokens`) and npz checkpoints
(`repro_torch.checkpoint`) against the JAX package's.

* `TokenStream.sample` gives the JAX package's tokens element for element,
  for three stream seeds, two stream times each, on the same numpy
  generator state.
* A checkpoint written by either package loads in the other: the same
  flat ``/``-joined keys, bfloat16 stored as float32, each leaf restored
  in the dtype of ``like`` (and, in the port, on its device); a
  NamedTuple comes back as itself in the port.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as ckpt_jax
from repro.data.tokens import StreamConfig as StreamConfigJax
from repro.data.tokens import TokenStream as TokenStreamJax
from repro_torch import checkpoint as ckpt
from repro_torch.core.masked_adam import MaskedAdamState
from repro_torch.data.tokens import StreamConfig, TokenStream


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("t", [0.0, 137.5])
def test_token_stream_samples_as_in_jax(seed, t):
    kw = dict(vocab_size=300, order_states=16, seed=seed)
    a = TokenStream(StreamConfig(**kw)).sample(np.random.default_rng(seed + 10), 3, 20, t)
    b = TokenStreamJax(StreamConfigJax(**kw)).sample(np.random.default_rng(seed + 10), 3,
                                                     20, t)
    assert a.dtype == b.dtype == np.int32 and a.shape == (3, 21)
    np.testing.assert_array_equal(a, b)


def _tree(rng):
    return {"embed": {"tok": rng.normal(size=(5, 4)).astype(np.float32)},
            "groups": {"b0": {"ln1": rng.normal(size=(2, 4)).astype(np.float32),
                              "w": rng.normal(size=(2, 4, 3)).astype(np.float32)}},
            "count": np.array(3, np.int32)}


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    raw = _tree(rng)
    t = {"embed": {"tok": torch.from_numpy(raw["embed"]["tok"]).to(torch.bfloat16)},
         "groups": {"b0": {"ln1": torch.from_numpy(raw["groups"]["b0"]["ln1"]),
                           "w": torch.from_numpy(raw["groups"]["b0"]["w"])}},
         "count": torch.tensor(3, dtype=torch.int32)}
    path = str(tmp_path / "port.npz")
    ckpt.save(path, t)
    assert ckpt.exists(path) and ckpt_jax.exists(path)
    like = {"embed": {"tok": jnp.zeros((5, 4), jnp.bfloat16)},
            "groups": {"b0": {"ln1": jnp.zeros((2, 4), jnp.float32),
                              "w": jnp.zeros((2, 4, 3), jnp.float32)}},
            "count": jnp.zeros((), jnp.int32)}
    got = ckpt_jax.load(path, like)
    assert got["embed"]["tok"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["embed"]["tok"]).astype(np.float32),
        t["embed"]["tok"].float().numpy())
    np.testing.assert_array_equal(np.asarray(got["groups"]["b0"]["w"]),
                                  raw["groups"]["b0"]["w"])
    assert int(got["count"]) == 3


def test_jax_checkpoint_loads_in_the_port(tmp_path, rng):
    raw = _tree(rng)
    j = {"embed": {"tok": jnp.asarray(raw["embed"]["tok"], jnp.bfloat16)},
         "groups": {"b0": {"ln1": jnp.asarray(raw["groups"]["b0"]["ln1"]),
                           "w": jnp.asarray(raw["groups"]["b0"]["w"])}},
         "count": jnp.asarray(3, jnp.int32)}
    path = str(tmp_path / "jax.npz")
    ckpt_jax.save(path, j)
    like = {"embed": {"tok": torch.zeros((5, 4), dtype=torch.bfloat16)},
            "groups": {"b0": {"ln1": torch.zeros((2, 4), dtype=torch.float64),
                              "w": torch.zeros((2, 4, 3))}},
            "count": torch.zeros((), dtype=torch.int32)}
    got = ckpt.load(path, like)
    assert got["embed"]["tok"].dtype == torch.bfloat16
    assert got["groups"]["b0"]["ln1"].dtype == torch.float64
    want_tok = np.asarray(j["embed"]["tok"]).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got["embed"]["tok"].float().numpy(), want_tok)
    np.testing.assert_array_equal(got["groups"]["b0"]["ln1"].numpy(),
                                  raw["groups"]["b0"]["ln1"].astype(np.float64))
    assert got["count"].item() == 3 and got["count"].dtype == torch.int32


def test_port_checkpoint_round_trip_keeps_named_tuples(tmp_path):
    st = MaskedAdamState(m={"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)},
                         v={"a": torch.ones(2, 3)},
                         count=torch.tensor(5, dtype=torch.int32))
    path = str(tmp_path / "opt")
    ckpt.save(path, st)
    like = MaskedAdamState(m={"a": torch.zeros(2, 3, dtype=torch.bfloat16)},
                           v={"a": torch.zeros(2, 3)},
                           count=torch.zeros((), dtype=torch.int32))
    got = ckpt.load(path + ".npz", like)
    assert isinstance(got, MaskedAdamState)
    assert torch.equal(got.m["a"], st.m["a"]) and got.m["a"].dtype == torch.bfloat16
    assert torch.equal(got.v["a"], st.v["a"]) and int(got.count) == 5
