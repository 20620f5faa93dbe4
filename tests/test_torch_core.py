"""The port's counter PRNG, bit packing, quantizer, RP matrix, VM levels and
seed scheme against the JAX reference, bit for bit.  Inputs are numpy
arrays from a seed, handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pack as j_pack
from repro.core import prng as j_prng
from repro.core import quant as j_quant
from repro.core import random_projection as j_rp
from repro.core.variance import optimize_levels as j_optimize_levels
from repro.engine import seeds as j_seeds
from repro_torch.core import pack as t_pack
from repro_torch.core import prng as t_prng
from repro_torch.core import quant as t_quant
from repro_torch.core import random_projection as t_rp
from repro_torch.core.variance import optimize_levels as t_optimize_levels
from repro_torch.engine import seeds as t_seeds


def _counters(n=4096, seed=0):
    """uint32 counters covering the whole range, values >= 2**31 included."""
    c = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    c[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    return c.astype(np.uint32)


def test_hash_u32_bit_equal():
    c = _counters()
    want = np.asarray(j_prng.hash_u32(jnp.asarray(c))).astype(np.int64)
    got = t_prng.hash_u32(torch.from_numpy(c.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_uniform_and_rademacher_bit_equal(seed):
    c = _counters(seed=seed % 97)
    ct = torch.from_numpy(c.astype(np.int64))
    np.testing.assert_array_equal(
        t_prng.uniform_from_counter(seed, ct).numpy(),
        np.asarray(j_prng.uniform_from_counter(seed, jnp.asarray(c))))
    np.testing.assert_array_equal(
        t_prng.rademacher_from_counter(seed, ct).numpy(),
        np.asarray(j_prng.rademacher_from_counter(seed, jnp.asarray(c))))


def test_knuth_constant():
    assert t_prng.KNUTH_MULT == int(j_prng.KNUTH_MULT)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [64, 100])
def test_pack_unpack_bit_equal(bits, n):
    codes = np.random.default_rng(bits * n).integers(0, 2**bits, (5, n))
    want = np.asarray(j_pack.pack(jnp.asarray(codes, jnp.int32), bits))
    got = t_pack.pack(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    np.testing.assert_array_equal(t_pack.unpack(got, bits, n).numpy(), codes)
    assert t_pack.packed_len(n, bits) == j_pack.packed_len(n, bits)
    assert (t_pack.packed_nbytes((7, n), bits, 64)
            == j_pack.packed_nbytes((7, n), bits, 64))


@pytest.mark.parametrize("n,g", [(1000, 256), (512, 256), (5, 64)])
def test_group_reshape_replicates_tail(n, g):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    jb, jn = j_quant.group_reshape(jnp.asarray(x), g)
    tb, tn = t_quant.group_reshape(torch.from_numpy(x), g)
    assert tn == jn
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("vm", [False, True])
@pytest.mark.parametrize("counter_base", [0, 2**32 - 100, 3 * 2**32 + 17])
def test_stochastic_round_counter_base_fold(vm, counter_base):
    """The 64-bit counter_base fold, across a 2**32 boundary included."""
    levels = (j_optimize_levels(32, 2) if vm
              else (0.0, 1.0, 2.0, 3.0))
    h = np.random.default_rng(3).uniform(0, 3, (40, 16)).astype(np.float32)
    want = j_quant.stochastic_round_to_levels(
        jnp.asarray(h), jnp.asarray(levels, jnp.float32), 99, counter_base)
    got = t_quant.stochastic_round_to_levels(
        torch.from_numpy(h), torch.tensor(levels, dtype=torch.float32), 99,
        counter_base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_in,d_out", [(256, 32), (512, 64), (128, 16),
                                        (40, 5)])
def test_rp_matrix_bit_equal(d_in, d_out):
    want = np.asarray(j_rp.rp_matrix(123, d_in, d_out))
    got = t_rp.rp_matrix(123, d_in, d_out).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("d,bits", [(32, 2), (64, 2), (16, 4)])
def test_optimize_levels_exact(d, bits):
    assert t_optimize_levels(d, bits) == j_optimize_levels(d, bits)


@pytest.mark.parametrize("ordinal", [0, 1, 41, 2**32 - 1, 2**33 + 3])
def test_seed_scheme(ordinal):
    want = j_seeds.sr_seed(ordinal)
    assert t_seeds.sr_seed(ordinal) == int(want)
    for li in range(3):
        assert t_seeds.layer_seed(t_seeds.sr_seed(ordinal), li) == int(
            j_seeds.layer_seed(want, li))
