"""The port's paged attention, paged cache and native scheduler against the
JAX package, on the CPU.

Inputs come from numpy seeds and reach both sides as the same arrays. The
JAX kernels run in interpret mode (its own tests' CPU route); the port's
CPU tensors take the plain versions of kernels B5 and B6. Tolerance: 2e-5
absolute at fp32 (the same scores summed in another order). The append
must write exactly what the JAX append writes, and the allocator and the
scheduler must make the same decisions as their JAX / C++ twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_cute_tpu.ops import paged_attention as jax_pa
from flash_attention_cute_tpu.runtime import paged_cache as jax_cache
from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops import paged_attention as pa
from flash_attention_cute_tpu_torch.runtime import engine, native, paged_cache
from flash_attention_cute_tpu_torch.runtime.paged_cache import PageAllocator

ATOL = 2e-5
REPO_CSRC = "flash_attention_cute_tpu/csrc/page_allocator.cpp"


def paged_inputs(seed, b, hq, hkv, sq, ps, pps, d=64, num_pages=None):
    """q [B, Hq, S, D], pools [Hkv, P, ps, D] and a table of distinct
    shuffled pages (page 0 in no table); every pool row holds random
    values, so a masked position that leaks shows up."""
    rng = np.random.default_rng(seed)
    num_pages = num_pages or b * pps + 1
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    return q, kp, vp, table


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


DECODE = {
    # name: (b, hq, hkv, ps, pps, lengths, window, softcap)
    "mha_len0_len1_ps8": (3, 4, 4, 8, 8, [64, 1, 0], None, None),
    "gqa_ragged_cross_page_ps16": (4, 8, 2, 16, 8, [17, 33, 127, 96], None, None),
    "mqa_ps32": (2, 4, 1, 32, 10, [300, 5], None, None),
    "windowed": (3, 8, 2, 16, 8, [100, 37, 128], 50, None),
    "softcap": (2, 4, 2, 16, 4, [60, 17], None, 15.0),
}


@pytest.mark.parametrize("case", list(DECODE))
def test_paged_decode_plain_matches_jax_kernel(case):
    b, hq, hkv, ps, pps, lens, window, softcap = DECODE[case]
    q, kp, vp, table = paged_inputs(len(case), b, hq, hkv, 1, ps, pps)
    lengths = np.asarray(lens, np.int32)
    want = jax_pa.paged_attention_decode(
        *j(q, kp, vp, lengths, table), window=window, logit_softcap=softcap,
        pages_per_compute_block=2, interpret=True,
    )
    got = pa.paged_attention_decode(*t(q, kp, vp, lengths, table), window=window,
                                    logit_softcap=softcap)
    assert got.shape == (b, hq, 1, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert (got[i] == 0).all()


EXTEND = {
    # name: (b, sq, ps, pps, q_offset, kv_length, window, softcap, head_dim)
    "offsets_inactive_ps8": (4, 16, 8, 16, [0, 50, 96, 20], [16, 66, 112, 0], None, None, 64),
    "offsets_ps16_s32": (2, 32, 16, 8, [50, 17], [82, 49], None, None, 64),
    "windowed": (2, 16, 8, 16, [80, 10], [96, 26], 30, None, 64),
    "softcap": (2, 32, 8, 16, [0, 40], [32, 72], None, 10.0, 64),
    "d256_softcap_window_inactive": (3, 16, 16, 8, [70, 3, 0], [86, 19, 0], 24, 50.0, 256),
}


@pytest.mark.parametrize("case", list(EXTEND))
def test_paged_extend_plain_matches_jax_kernel(case):
    b, sq, ps, pps, offs, kvl, window, softcap, d = EXTEND[case]
    q, kp, vp, table = paged_inputs(len(case) + 100, b, 4, 2, sq, ps, pps, d)
    off, kvl = np.asarray(offs, np.int32), np.asarray(kvl, np.int32)
    want = jax_pa.paged_attention_extend(
        *j(q, kp, vp, off, kvl, table), window=window, logit_softcap=softcap,
        pages_per_compute_block=2, interpret=True,
    )
    got, clamps = pa.paged_attention_extend(*t(q, kp, vp, off, kvl, table), window=window,
                                            logit_softcap=softcap, return_clamps=True)
    assert clamps == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for i, n in enumerate(kvl):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("d,ps,want", [
    (64, 8, (128, 8)), (128, 16, (128, 16)), (128, 128, (128, 128)), (128, 256, (128, 128)),
    (256, 16, (64, 16)), (256, 128, (64, 64)), (128, 24, (128, 8)), (256, 40, (64, 8)),
])
def test_extend_plan(d, ps, want):
    """B6 / B9 copy tiles of 128 keys (64 at D 256) in parts of a page, or
    of a page's largest power-of-two divisor when it does not divide the
    tile, never more than a tile."""
    assert pa.extend_plan(d, ps) == want


def test_extend_plan_parts_fit_tiles_and_pages():
    """Every part starts on a tile's and a page's boundary and holds at
    least the 8 rows the copies' 128-byte swizzle spans, for every page
    size the wrapper takes (multiples of 8)."""
    for d in (64, 128, 256):
        for ps in range(8, 1032, 8):
            tile, part = pa.extend_plan(d, ps)
            assert tile % part == 0 and ps % part == 0 and part >= 8


@pytest.mark.parametrize("d,ps,want", [
    (64, 8, (64, 8)), (64, 128, (64, 64)), (128, 16, (32, 16)), (128, 128, (32, 32)),
    (256, 16, (32, 16)), (256, 24, (32, 8)), (128, 8, (32, 8)),
])
def test_decode_plan(d, ps, want):
    """B5 / B8 walk tiles of 64 keys at D 64 and 32 above, each copied in
    parts of a page, or of the largest divisor of the tile and the page."""
    assert pa.decode_plan(d, ps) == want


def test_decode_plan_parts_fit_tiles_and_pages():
    for d in (64, 128, 256):
        for ps in range(8, 1032, 8):
            tile, part = pa.decode_plan(d, ps)
            assert tile % part == 0 and ps % part == 0 and part >= 8


# The decode shapes of chip_smoke.py's serving runs: (batch, kv heads,
# table capacity, head dim): runs A-G (8 slots of 2048 keys), Mistral M1 /
# M2 and Gemma G1 / G2 / G3 (4 slots of 5120 / 5040), Llama's greedy batch.
SMOKE_DECODES = {"runs_a_g": (8, 8, 2048, 128), "m1": (4, 8, 5120, 128),
                 "m2": (4, 8, 5040, 128), "g1": (4, 8, 5120, 256), "g2_g3": (4, 8, 5040, 256),
                 "greedy_b4": (4, 8, 576, 128)}


@pytest.mark.parametrize("shape", list(SMOKE_DECODES))
def test_paged_decode_splits_fill_whole_waves(shape):
    """At the smoke's decode shapes the grid is one whole wave: at most the
    card's slots (132 SMs x blocks an SM: 1 at D 256, 2 below) and at
    least 90 % of them."""
    b, hkv, cap, d = SMOKE_DECODES[shape]
    slots = dispatch.NUM_SMS * (1 if d == 256 else 2)
    blocks = b * hkv * dispatch.decode_num_splits(b, hkv, cap, d)
    assert 0.9 * slots <= blocks <= slots


@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_decode_splits_at_least_one_and_no_shorter_than_a_tile(d):
    """At least one split; more than one only where each covers a tile of
    the capacity; the count is a function of the shapes alone."""
    tile = dispatch.decode_tile(d)
    for b in (1, 2, 3, 8, 64, 300):
        for hkv in (1, 2, 8):
            for cap in (8, 16, 40, 64, 576, 2048, 5120):
                s = dispatch.decode_num_splits(b, hkv, cap, d)
                assert s >= 1
                assert s == 1 or cap // s >= tile


def test_paged_plain_versions_never_read_past_the_lengths():
    """NaN in every pool row at or past a row's length (and in page 0)
    must not reach the output: those positions may be uninitialised."""
    q, kp, vp, table = paged_inputs(7, 3, 8, 2, 1, 8, 6)
    lens = [0, 9, 48]
    clean = pa.paged_attention_decode(*t(q, kp, vp, np.asarray(lens, np.int32), table))
    for b, n in enumerate(lens):
        for pos in range(n, 48):
            for pool in (kp, vp):
                pool[:, table[b, pos // 8], pos % 8] = np.nan
    kp[:, 0] = vp[:, 0] = np.nan
    got = pa.paged_attention_decode(*t(q, kp, vp, np.asarray(lens, np.int32), table))
    assert torch.equal(got, clean)
    qe = np.random.default_rng(8).standard_normal((3, 8, 5, 64), dtype=np.float32)
    off = np.asarray([0, 4, 43], np.int32)
    out = pa.paged_attention_extend(*t(qe, kp, vp, off, np.asarray([0, 9, 48], np.int32), table))
    assert torch.isfinite(out).all() and (out[0] == 0).all()


APPEND = {
    # name: (s, lengths before the append, active): table row 1 holds the
    # real page 0; row 2 runs past the end of its table.
    "decode_s1": (1, [3, 2, 32, 0], [True, True, True, False]),
    "chunk_s11": (11, [0, 5, 26, 2], [True, True, True, False]),
}


@pytest.mark.parametrize("case", list(APPEND))
def test_paged_append_matches_jax_exactly(case):
    s, lens, act = APPEND[case]
    rng = np.random.default_rng(11)
    hkv, num_pages, ps, d, pps = 2, 17, 8, 16, 4
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    table = np.array([[5, 9, 2, 14], [0, 7, 11, 3], [1, 4, 6, 8], [10, 12, 13, 15]], np.int32)
    k_new = rng.standard_normal((4, hkv, s, d), dtype=np.float32)
    v_new = rng.standard_normal((4, hkv, s, d), dtype=np.float32)
    lengths, active = np.asarray(lens, np.int32), np.asarray(act)
    want_k, want_v = jax_cache.paged_append_layer(*j(kp, vp, k_new, v_new, table, lengths,
                                                     active))
    got_k, got_v = t(kp.copy(), vp.copy())
    out = paged_cache.paged_append_layer(got_k, got_v, *t(k_new, v_new, table, lengths, active))
    assert out[0] is got_k and out[1] is got_v  # in place
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert not np.array_equal(got_k.numpy(), kp)


def test_create_paged_state_defaults_to_cuda_and_zeroes_the_pool():
    import inspect

    from flash_attention_cute_tpu_torch.models.config import tiny_test_config

    sig = inspect.signature(paged_cache.create_paged_state)
    assert sig.parameters["device"].default == "cuda"
    st = paged_cache.create_paged_state(tiny_test_config(), 5, 8, 2, 3, device="cpu")
    cfg = tiny_test_config()
    assert st.k_pages.shape == (cfg.num_layers, cfg.num_kv_heads, 5, 8, cfg.head_dim)
    assert not st.k_pages.any() and not st.v_pages.any()
    assert st.page_table.dtype == torch.int32 and st.lengths.tolist() == [0, 0]
    assert (st.page_size, st.num_pages) == (8, 5)


def allocator_ops(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng.random() < 0.7, int(rng.integers(0, 5)), int(rng.integers(0, 30)), \
            int(rng.integers(0, 20))


@pytest.mark.parametrize("make", [PageAllocator, native.make_page_allocator],
                         ids=["python", "native"])
def test_page_allocator_matches_jax(make):
    """Allocation and release only: the JAX allocator's page sharing and
    pins belong to the prefix cache, which the port does not serve yet."""
    ours, ref = make(20, 4, 6), jax_cache.PageAllocator(20, 4, 6)
    lens: dict[int, int] = {}
    refused = 0
    for grow, seq, n, m in allocator_ops(3, 400):
        if grow:
            cur = lens.get(seq, 0)
            ok = ours.allocate(seq, cur, n)
            assert ok == ref.allocate(seq, cur, n)
            refused += not ok
            lens[seq] = cur + n if ok else cur
        else:
            ours.release(seq)
            ref.release(seq)
            lens.pop(seq, None)
        assert ours.num_free == ref.num_free
        assert ours.pages_needed(n, m) == ref.pages_needed(n, m)
        np.testing.assert_array_equal(ours.table_row(seq), ref.table_row(seq))
    assert refused > 0  # the pool and the per-sequence table ran out


def test_native_source_is_a_byte_identical_copy():
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    assert native.SRC.read_bytes() == (repo / REPO_CSRC).read_bytes()
    assert native.SRC.is_relative_to(repo / "flash_attention_cute_tpu_torch")


def test_native_build_lands_in_the_port_build_dir():
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert native.load() is native.load()


def test_native_scheduler_lockstep_with_python_twin():
    """Random-driven parity: the C++ scheduler and the port's Python twin
    make identical decisions (admission, steps, victims, slots, pages)."""
    cc = native.NativeScheduler(12, 4, 8, slots=3)
    py = engine._PyScheduler(12, 4, 8, slots=3)
    rng = np.random.default_rng(7)
    plens: dict[int, int] = {}
    done: set[int] = set()
    for step in range(600):
        op = rng.random()
        if op < 0.22:
            rid, plen = len(plens), int(rng.integers(1, 20))
            mnew, pri = int(rng.integers(1, 10)), int(rng.integers(0, 2))
            plens[rid] = plen
            cc.submit(rid, plen, mnew, pri)
            py.submit(rid, plen, mnew, pri)
        elif op < 0.38:
            assert cc.admit() == py.admit(), step
        elif op < 0.72:
            s = int(rng.integers(0, 3))
            assert cc.step_slot(s) == py.step_slot(s), step
        elif op < 0.80:
            assert cc.preempt_youngest() == py.preempt_youngest(), step
        else:
            s = int(rng.integers(0, 3))
            assert cc.finished(s) == py.finished(s)
            if cc.finished(s):
                done.add(cc.slot_id(s))
                cc.release_slot(s, requeue=False)
                py.release_slot(s, requeue=False)
        assert cc.num_waiting == py.num_waiting, step
        assert cc.num_free_pages == py.num_free_pages, step
        for s in range(3):
            assert cc.slot_id(s) == py.slot_id(s), (step, s)
            assert cc.slot_generated(s) == py.slot_generated(s), (step, s)
            rid = cc.slot_id(s)
            if rid != -1:
                np.testing.assert_array_equal(cc.table_row(rid), py.table_row(rid))
    assert len(done) >= 5  # requests finished
