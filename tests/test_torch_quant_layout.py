"""The quant kernels' lane layout (``csrc/quant_blockwise.cu``), mirrored in
numpy, against the JAX reference's words on the CPU.

The CUDA kernels run only on the card; their index math is mirrored here.
Vector path (G of 64, 128 or 256): a group of L = G / 16 lanes takes one
block and lane l its four chunks c = l + i * L (elements 4c .. 4c+3).
Chunk c's four codes go to words 4 (c % Q) .. +3 at shift (c // Q) * bits,
Q = W / 4; a lane ORs them into the partial uint4 of slot i % (Q / L) (two
slots where Q = 2L, at 16 bits); where Q < L the lanes that share l % Q OR
their partial words together with xor-shuffles at offsets Q .. L/2, and
lane l < Q stores slot s at uint4 (l % Q) + s * L.  Dequantize: lane l
loads those uint4s and extracts field c // Q of each word for each of its
chunks.  Scalar path: one warp a block, lane j builds words j, j + 32, ...
from codes j, j + W, j + 2W, ... and unpacks them back to the same columns.

The mirror packs the reference's codes and must rebuild, bit for bit, the
words of JAX's ``quant_pack_call`` (interpret mode) and of its jnp path;
its extraction must give the codes of the reference's unpack and, through
the kernels' ``v * (range / B) + zero``, the port's plain dequantized
values bit for bit (JAX's own within its 1e-5 band)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pack as j_pack
from repro.core import quant as j_quant
from repro.kernels import ref as j_ref
from repro.kernels.quant_blockwise import dequant_unpack_call, quant_pack_call
from repro_torch.core.variance import optimize_levels
from repro_torch.kernels import quant_blockwise as t_qk
from repro_torch.kernels import ref as t_ref
from torch_threads import one_thread  # noqa: F401

WARP = 32


def _x(n, g, seed):
    return (np.random.default_rng(seed).normal(size=(n, g)) * 2.3
            + 0.7).astype(np.float32)


def _warp_tiles(n, lanes):
    """(tiles, 32) block of each lane and its lane within the block: warp
    tile t holds blocks t * (32 / L) .. + 32 / L - 1."""
    per_warp = WARP // lanes
    lane = np.arange(WARP)
    tiles = np.arange(-(-n // per_warp))[:, None]
    return tiles * per_warp + lane // lanes, np.broadcast_to(
        lane % lanes, (tiles.shape[0], WARP))


def _shuffle_xor(v, offset, lanes):
    """__shfl_xor_sync over the warp axis (axis 1); the offset must stay
    within a lane's block (a segmented shuffle)."""
    lane = np.arange(WARP)
    assert np.all((lane ^ offset) // lanes == lane // lanes)
    return v[:, lane ^ offset]


#: A lane's 16-byte chunks of its block on the vector path.
CHUNKS = 4


def _geometry(g, bits):
    """(L lanes a block, Q uint4s of words a block, slots a lane holds)."""
    lanes = t_qk.lanes_per_block(g, bits)
    q = g * bits // 128
    assert lanes == g // 16 and q >= 1 and (lanes % q == 0 or q % lanes == 0)
    return lanes, q, max(1, q // lanes)


def vector_pack(codes, bits):
    """The vector path's words for (n, G) codes: each lane's partial uint4s
    from its four chunks, OR-combined across the lanes that share a uint4,
    stored once."""
    n, g = codes.shape
    lanes, q, slots = _geometry(g, bits)
    block, l = _warp_tiles(n, lanes)
    valid = block < n
    cz = np.concatenate([codes, np.zeros((WARP, g), codes.dtype)])
    part = np.zeros(block.shape + (slots, 4), np.uint64)
    for i in range(CHUNKS):
        c = l + i * lanes
        s = i % slots
        assert np.all(c % q == l % q + s * lanes)       # the slot's uint4
        assert np.all(c // q == l // q + (i * lanes) // q)   # its field
        for e in range(4):
            part[..., s, e] |= (cz[block, 4 * c + e].astype(np.uint64)
                                << ((c // q) * bits).astype(np.uint64))
    offset = 1
    while offset < WARP:
        if q <= offset < lanes:
            part |= _shuffle_xor(part, offset, lanes)
        offset *= 2
    words = np.zeros((n, g * bits // 32), np.uint64)
    stores = np.zeros(words.shape, np.int64)
    store = valid & (l < q)
    for s in range(slots):
        uint4 = l[store] % q + s * lanes
        for e in range(4):
            np.add.at(stores, (block[store], 4 * uint4 + e), 1)
            words[block[store], 4 * uint4 + e] = part[..., s, e][store]
    assert np.all(stores == 1)          # every word stored once
    assert np.all(words < 2**32)
    return words.astype(np.uint32)


def vector_unpack(words, bits, g):
    """The vector path's codes: lane l loads the uint4s (l % Q) + s * L of
    its block's words and extracts field c // Q for its chunks c."""
    n = words.shape[0]
    lanes, q, slots = _geometry(g, bits)
    block, l = _warp_tiles(n, lanes)
    valid = block < n
    mask = np.uint32(2**bits - 1)
    codes = np.zeros((n, g), np.int64)
    writes = np.zeros((n, g), np.int64)
    bv, lv = block[valid], l[valid]
    for i in range(CHUNKS):
        c = lv + i * lanes
        uint4 = lv % q + (i % slots) * lanes
        for e in range(4):
            word = words[bv, 4 * uint4 + e]
            codes[bv, 4 * c + e] = (word >> ((c // q) * bits)
                                    .astype(np.uint32)) & mask
            np.add.at(writes, (bv, 4 * c + e), 1)
    assert np.all(writes == 1)          # every element written once
    return codes


def scalar_pack(codes, bits):
    """The scalar path: lane j of the block's warp builds words j, j + 32,
    ... from codes j, j + W, j + 2W, ..."""
    n, g = codes.shape
    vpw = 32 // bits
    w = g // vpw
    words = np.zeros((n, w), np.uint64)
    for lane in range(WARP):
        for j in range(lane, w, WARP):
            for k in range(vpw):
                words[:, j] |= codes[:, j + k * w].astype(np.uint64) << (k * bits)
    return words.astype(np.uint32)


def scalar_unpack(words, bits, g):
    w = words.shape[1]
    codes = np.zeros((words.shape[0], g), np.int64)
    for lane in range(WARP):
        for j in range(lane, w, WARP):
            for k in range(32 // bits):
                codes[:, j + k * w] = (words[:, j] >> np.uint32(k * bits)) \
                    & np.uint32(2**bits - 1)
    return codes


def _dequant(codes, zero, rng, bits, levels):
    """The kernels' v * (range / B) + zero, each step rounded to f32."""
    v = (np.arange(2**bits, dtype=np.float32) if levels is None
         else np.asarray(levels, np.float32))[codes]
    scale = rng / np.float32(2**bits - 1)
    return v * scale[:, None] + zero[:, None]


def _reference(x, bits, seed, levels, rows_per_seed):
    """JAX's codes, jnp-path words and Pallas (interpret) words, zero and
    range; with a seed table each run of rows quantized alone."""
    runs = ([(x, seed)] if rows_per_seed is None else
            [(x[r * rows_per_seed:(r + 1) * rows_per_seed], s)
             for r, s in enumerate(seed)])
    lv = None if levels is None else jnp.asarray(levels, jnp.float32)
    codes, jnp_words, pallas_words, zeros, rngs = [], [], [], [], []
    for xr, s in runs:
        c, z, r = j_quant.quantize_grouped(jnp.asarray(xr), bits, int(s), lv)
        codes.append(np.asarray(c))
        jnp_words.append(np.asarray(j_ref.quantize_packed(
            jnp.asarray(xr), bits, int(s), levels)[0]))
        pad = (-len(xr)) % 8
        xp = np.concatenate([xr, np.zeros((pad, xr.shape[1]), np.float32)])
        p, zi, ri = quant_pack_call(jnp.asarray(xp), bits, int(s), levels,
                                    interpret=True)
        pallas_words.append(np.asarray(p)[:len(xr)])
        zeros.append(np.asarray(zi)[:len(xr), 0])
        rngs.append(np.asarray(ri)[:len(xr), 0])
        np.testing.assert_array_equal(zeros[-1], np.asarray(z))
        np.testing.assert_array_equal(rngs[-1], np.asarray(r))
    return (np.concatenate(codes), np.concatenate(jnp_words),
            np.concatenate(pallas_words), np.concatenate(zeros),
            np.concatenate(rngs))


VM = {b: optimize_levels(32, b) for b in (1, 2, 4)}

#: (G, bits, levels, n blocks, rows per seed): the vector path's widths at
#: 1, 2, 4, 8 and 16 bits (a uniform and a VM table where VM takes the
#: width; at G = 128 and 16 bits a lane holds two uint4s of words), a seed
#: table, counts that leave a warp tile part-filled, and the scalar path's
#: configurations (bits 1 at G = 64, G = 250 at bits 16, G off 64/128/256).
CASES = {
    "g256_b2_uniform": (256, 2, None, 37, None),
    "g256_b2_vm": (256, 2, "vm", 37, None),
    "g64_b4_uniform": (64, 4, None, 37, None),
    "g64_b4_vm": (64, 4, "vm", 37, None),
    "g64_b8_uniform": (64, 8, None, 21, None),
    "g128_b16_uniform": (128, 16, None, 19, None),
    "g256_b16_uniform": (256, 16, None, 5, None),
    "g128_b1_vm": (128, 1, "vm", 11, None),
    "g64_b4_seed_table": (64, 4, None, 40, 8),
    "g256_b2_vm_seed_table": (256, 2, "vm", 24, 3),
    "g128_b2_ragged": (128, 2, None, 13, None),
    "scalar_g64_b1_uniform": (64, 1, None, 21, None),
    "scalar_g64_b1_vm": (64, 1, "vm", 21, None),
    "scalar_g250_b16": (250, 16, None, 11, None),
    "scalar_g96_b4_vm": (96, 4, "vm", 9, None),
    "scalar_g32_b4": (32, 4, None, 13, None),
    "scalar_g8_b16": (8, 16, None, 45, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_layout_rebuilds_reference_words(case):
    g, bits, lv_name, n, rps = CASES[case]
    levels = VM[bits] if lv_name == "vm" else None
    x = _x(n, g, seed=n * g + bits)
    rs = np.random.default_rng(bits)
    seed = (rs.integers(0, 2**32, n // rps, dtype=np.uint64) if rps
            else 2**32 - 7)
    codes, jnp_words, pallas_words, zero, rng = _reference(
        x, bits, seed, levels, rps)
    np.testing.assert_array_equal(jnp_words, pallas_words)
    vector = t_qk.lanes_per_block(g, bits) > 0
    # each configuration held to its own path's rule
    assert vector == (not case.startswith("scalar"))
    pack, unpack = ((vector_pack, vector_unpack) if vector
                    else (scalar_pack, scalar_unpack))
    words = pack(codes, bits)
    np.testing.assert_array_equal(words, jnp_words)

    back = unpack(words, bits, g)
    np.testing.assert_array_equal(
        back, np.asarray(j_pack.unpack(jnp.asarray(jnp_words), bits, g)))
    np.testing.assert_array_equal(back, codes)
    values = _dequant(back, zero, rng, bits, levels)
    plain = t_ref.dequantize_packed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(zero),
        torch.from_numpy(rng), bits, g, levels).numpy()
    np.testing.assert_array_equal(values, plain)
    pad = (-n) % 8
    wp = np.concatenate([pallas_words, np.zeros((pad, words.shape[1]),
                                                np.uint32)])
    zr = np.concatenate([zero, np.zeros(pad, np.float32)])[:, None]
    rr = np.concatenate([rng, np.zeros(pad, np.float32)])[:, None]
    interp = np.asarray(dequant_unpack_call(
        jnp.asarray(wp), jnp.asarray(zr), jnp.asarray(rr), bits, g, levels,
        interpret=True))[:n]
    np.testing.assert_allclose(values, interp, atol=1e-5)


@pytest.mark.parametrize("g,bits,lanes", [
    (64, 2, 4), (64, 4, 4), (64, 16, 4), (128, 1, 8), (128, 16, 8),
    (256, 2, 16), (256, 16, 16), (64, 1, 0), (32, 4, 0), (8, 16, 0),
    (512, 2, 0), (250, 16, 0), (96, 4, 0)])
def test_lanes_per_block_rule(g, bits, lanes):
    """The vector path takes G of 64, 128 or 256 whose words fill whole
    uint4s; a block's L = G / 16 lanes then hold its G / 4 chunks four a
    lane, and its Q = W / 4 uint4s and its lanes divide one another."""
    assert t_qk.lanes_per_block(g, bits) == lanes
    if lanes:
        q = g * bits // 128
        assert CHUNKS * lanes * 4 == g and q >= 1
        assert lanes % q == 0 or q == 2 * lanes


# ------------------------------------------ the kernels' rounding identities
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_floor_by_round_down_add_is_floor(bits):
    """``sr_code_q``'s floor: for 0 <= h <= B, h + 2**23 rounded down is
    exactly 2**23 + floor(h), so its low mantissa bits are floor(h) and
    t - 2**23 is floor(h) as a float."""
    b = 2**bits - 1
    rs = np.random.default_rng(bits)
    h = np.concatenate([
        rs.uniform(0, b, 100_000), np.arange(b + 1),
        np.nextafter(np.arange(1, b + 1, dtype=np.float32), np.float32(0)),
        [np.float32(1e-40), np.float32(2**-24)]]).astype(np.float32)
    exact = h.astype(np.float64) + 2.0**23
    t = exact.astype(np.float32)                          # to nearest
    t = np.where(t.astype(np.float64) > exact,            # then down
                 np.nextafter(t, np.float32(0)), t).astype(np.float32)
    np.testing.assert_array_equal(
        t.view(np.uint32) - np.uint32(0x4B000000),
        np.floor(h).astype(np.uint32))
    np.testing.assert_array_equal(t - np.float32(2**23), np.floor(h))


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_saturated_quotient_times_b_is_the_clip(bits):
    """``sr_code_q`` clips by saturating q before the product:
    sat(q) * B == clip(q * B, 0, B) in float32 for q in and around [0, 1],
    at the float32 neighbours of 1, for infinities, and for NaN (both 0)."""
    b = np.float32(2**bits - 1)
    rs = np.random.default_rng(bits + 7)
    one = np.float32(1)
    q = np.concatenate([
        rs.uniform(0, 1, 100_000), rs.uniform(-2, 3, 10_000),
        [0.0, -0.0, 1.0, np.nextafter(one, np.float32(0)),
         np.nextafter(one, np.float32(2)), np.inf, -np.inf, np.nan,
         1e-45, 3.4e38]]).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        clip = np.fmin(np.fmax(q * b, np.float32(0)), b)      # fmaxf / fminf
        sat = np.fmin(np.fmax(q, np.float32(0)), one) * b     # NaN -> 0
    np.testing.assert_array_equal(sat, clip)


@pytest.mark.parametrize("divisor", [1e-10, 2.0**-40, 7.3e-6, 1.0, 3.0,
                                     1234.5, 2.0**40])
def test_block_divisor_numerator_test(divisor):
    """``BlockDivisor``'s fast-path test of a numerator a >= +0, one
    unsigned compare of bit patterns (a - 1 >= bits(d * 2**-40) - 1),
    holds exactly for a == +0 and for a >= d * 2**-40."""
    d = np.float32(divisor)
    least = np.float32(d * np.float32(2.0**-40))
    assert least.astype(np.float64) == np.float64(d) * 2.0**-40   # exact
    rs = np.random.default_rng(int(divisor * 1e3) % 2**32)
    a = np.concatenate([
        rs.uniform(0, 1, 10_000) * d, rs.uniform(0, 4, 1_000) * least,
        [0.0, least, np.nextafter(least, np.float32(0)),
         np.nextafter(least, np.float32(np.inf)), 1e-45, 1.1754942e-38, d,
         np.inf]]).astype(np.float32)
    lhs = a.view(np.uint32) - np.uint32(1) >= least.view(np.uint32) - 1
    np.testing.assert_array_equal(lhs, (a == 0) | (a >= least))
