"""The linear leaves' one-record layout of lightgbm_tpu_torch on the CPU.

tree_lin_raw (csrc/traverse.cu) and its plain version read a linear
leaf as one 64-byte record (ops/traverse_kernels.py pack_linear: the
intercept, 8 coefficients, 8 column ids of 20 bits, the leaf's constant
value, the live count). Held here:

- the records decode (unpack_linear) to the frozen arrays: float32 and
  bfloat16 storage (widened exactly), columns up to 2^20 - 1, dead
  slots' columns zero; a column of 2^20 or more is refused;
- the plain version's lane values from the records equal, bit for bit,
  a numpy float32 transcription of the kernel's arithmetic (slots in
  order 0..7, each product rounded before its add, a dead or NaN slot
  adding 0.0, the constant leaf value where the count is 0 or a live
  column is NaN), on random leaves reached by rows with NaN;
- the same lane values against the JAX package's _linear_leaf_values
  (lightgbm_tpu/serving/compiled_model.py:138, which sums the slots in
  an order XLA picks, after them the intercept): equal where a lane has
  at most one live slot,
  within 9 float32 roundings of the lane's terms' magnitude elsewhere,
  and the same fallback lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.serving.compiled_model import _linear_leaf_values
from lightgbm_tpu_torch.ops import traverse_kernels as tk

EPS32 = float(np.finfo(np.float32).eps)


def _blocks(rng, t, l, f, c=tk.COEF_PAD):
    cnt = rng.randint(0, c + 1, size=(t, l)).astype(np.int32)
    cnt[rng.rand(t, l) < 0.25] = 0
    feat = rng.randint(0, f, size=(t, l, c)).astype(np.int32)
    coef = rng.randn(t, l, c) * 0.3
    const = rng.randn(t, l)
    return const, coef, feat, cnt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_records_decode_to_the_frozen_arrays(dtype):
    rng = np.random.RandomState(1)
    const, coef, feat, cnt = _blocks(rng, 7, 5, (1 << 20) - 1, c=6)
    feat[0, 0, :] = (1 << 20) - 1          # every bit of a column
    feat[0, 1, :] = [0, 1, 0xFFFF, 0x10000, 0xF0000, 0xABCDE]
    cnt[0, :2] = 6
    values = rng.randn(7, 5)
    lin = tk.freeze_linear(const, coef, feat, cnt, values, dtype, "cpu")
    assert lin.rec.shape == (7, 5, tk.REC_WORDS)
    assert lin.rec.dtype == torch.int32 and lin.dtype == dtype
    live = np.arange(tk.COEF_PAD)[None, None, :] < cnt[:, :, None]
    assert lin.width == int(np.pad(feat, ((0, 0), (0, 0), (0, 2)))[
        live].max()) + 1
    got_c, got_co, got_f, got_n, got_v = tk.unpack_linear(lin)

    def stored(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).float()

    pad = ((0, 0), (0, 0), (0, tk.COEF_PAD - 6))
    assert torch.equal(got_c, stored(const))
    assert torch.equal(got_co, stored(np.pad(coef, pad)))
    assert torch.equal(got_f, torch.from_numpy(np.where(
        live, np.pad(feat, pad), 0).astype(np.int32)))
    assert torch.equal(got_n, torch.from_numpy(cnt))
    assert torch.equal(got_v, stored(values))


def test_a_column_past_20_bits_is_refused():
    rng = np.random.RandomState(2)
    const, coef, feat, cnt = _blocks(rng, 2, 3, 10)
    values = np.zeros((2, 3))
    cnt[1, 2] = 1
    feat[1, 2, 0] = tk.MAX_COLUMNS
    with pytest.raises(ValueError, match="2\\^20"):
        tk.freeze_linear(const, coef, feat, cnt, values, torch.float32,
                         "cpu")
    cnt[1, 2] = 0                           # a dead slot is not read
    tk.freeze_linear(const, coef, feat, cnt, values, torch.float32, "cpu")


def _lanes(seed, dtype, b=64, t=9, l=6, f=12):
    rng = np.random.RandomState(seed)
    const, coef, feat, cnt = _blocks(rng, t, l, f)
    lv = torch.from_numpy(rng.randn(t, l).astype(np.float32)).to(dtype)
    lin = tk.freeze_linear(const, coef, feat, cnt, lv.float().numpy(), dtype,
                           "cpu")
    x = rng.randn(b, f).astype(np.float32)
    x[rng.rand(b, f) < 0.1] = np.nan
    leaves = rng.randint(0, l, size=(b, t))
    return lin, lv, x, leaves


def _numpy_lanes(lin, x, leaves):
    """The kernel's arithmetic in numpy float32, one lane at a time."""
    const, coef, feat, cnt, base = (a.numpy() for a in
                                    tk.unpack_linear(lin))
    out = np.zeros(leaves.shape, np.float32)
    for r in range(leaves.shape[0]):
        for t in range(leaves.shape[1]):
            lf = leaves[r, t]
            n = cnt[t, lf]
            a, nan = np.float32(const[t, lf]), False
            for j in range(tk.COEF_PAD):
                prod = np.float32(0.0)
                if j < n:
                    xv = x[r, feat[t, lf, j]]
                    if np.isnan(xv):
                        nan = True
                    else:
                        prod = np.float32(coef[t, lf, j] * xv)
                a = np.float32(a + prod)
            out[r, t] = base[t, lf] if n <= 0 or nan else a
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_lane_values_are_the_kernel_arithmetic(dtype):
    lin, lv, x, leaves = _lanes(3, dtype)
    got = tk.linear_leaf_values_plain(torch.from_numpy(x),
                                      torch.from_numpy(leaves), lin)
    want = _numpy_lanes(lin, x, leaves)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_lane_values_against_jax(dtype):
    lin, lv, x, leaves = _lanes(4, dtype)
    const, coef, feat, cnt, _ = (a.numpy() for a in tk.unpack_linear(lin))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax.jit(_linear_leaf_values)(
        jnp.asarray(x), jnp.asarray(~leaves.astype(np.int32)),
        jnp.asarray(lv.float().numpy()).astype(jdt),
        jnp.asarray(const).astype(jdt), jnp.asarray(coef).astype(jdt),
        jnp.asarray(feat), jnp.asarray(cnt)))
    got = tk.linear_leaf_values_plain(torch.from_numpy(x),
                                      torch.from_numpy(leaves), lin).numpy()
    t_idx = np.arange(leaves.shape[1])[None, :]
    n = cnt[t_idx, leaves]
    xf = np.nan_to_num(x[np.arange(len(x))[:, None, None],
                         feat[t_idx, leaves]])
    live = np.arange(tk.COEF_PAD)[None, None, :] < n[:, :, None]
    mag = np.abs(const[t_idx, leaves]) + np.where(
        live, np.abs(coef[t_idx, leaves] * xf), 0.0).sum(axis=2)
    few = n <= 1
    np.testing.assert_array_equal(got[few].view(np.int32),
                                  want[few].view(np.int32))
    assert np.all(np.abs(got - want) <= 9 * EPS32 * mag + 1e-30)
    base = lv.float().numpy()[t_idx, leaves]
    assert np.array_equal(got == base, want == base)
