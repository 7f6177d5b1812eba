"""The port's sequence parallelism (flash_attention_cute_tpu_torch.parallel)
against the JAX package's, on the CPU.

The port's `allgather_attention` and `ring_attention` run SPMD over a real
gloo world of 4 processes, spawned once for the module (never forked: this
process has JAX loaded; the children import torch and the port only, so JAX
is imported inside the test functions). Each rank computes its shard of
every case from the same numpy-seeded global inputs and sends it back; a
child that hangs fails the module's fixture at its timeout. The JAX side
runs on a 4-device "sp" mesh taken from the 8 virtual CPU devices
(tests/conftest.py), on its XLA route, and once on its Pallas partials in
interpret mode. The port's ring runs B4's partials on every device (their
plain version on the CPU), so its zig-zag and three-offset paths run here.
Tolerance: fp32 results within JAX's own 2e-5 absolute (the same sums in
another order, log2 against natural-log units).
"""

import functools
import multiprocessing
import queue as queue_module
import socket
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 120

# name: (b, hq, hkv, s, d, entry point, causal, keyword arguments).
CASES = {
    "ring noncausal": (2, 4, 2, 64, 16, "ring", False, {}),
    "ring causal even": (2, 4, 2, 64, 16, "ring", True, {}),
    "ring causal odd": (1, 4, 2, 60, 16, "ring", True, {}),
    "ring gqa": (1, 8, 2, 48, 32, "ring", True, {}),
    "allgather causal": (2, 4, 2, 64, 16, "allgather", True, {}),
    "allgather noncausal": (2, 4, 2, 64, 16, "allgather", False, {}),
    "allgather window": (1, 4, 2, 64, 16, "allgather", True, {"window": 21}),
    # Head dim 320, which B4's partials run in the wide layout of 512 on the
    # card (MQA, ranks of 16 tokens).
    "ring d320 causal": (1, 4, 1, 64, 320, "ring", True, {}),
    "ring d320 noncausal": (1, 4, 1, 64, 320, "ring", False, {}),
    "allgather d320 window": (1, 4, 1, 64, 320, "allgather", True, {"window": 21}),
}
# JAX's Pallas partials in interpret mode run on this case alone: the
# three-offset path, whose later chunk gives the kernel an empty walk.
INTERPRET_CASE = "ring causal odd"
# A ring of one rank: the ("data", "model") mesh of make_mesh(model=1),
# each rank holding the whole sequence on its "model" axis.
WORLD1 = (1, 4, 2, 32, 16)


def inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _rank_main(rank, port, results):
    """One rank of the gloo world: every case's output shard, the world of
    one, and the meshes' shapes, put on `results` (or the traceback)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from flash_attention_cute_tpu_torch.parallel import mesh as pmesh
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    torch.set_num_threads(1)
    try:
        pmesh.init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                               world_size=WORLD, rank=rank)
        pmesh.init_distributed()  # idempotent
        sp = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("sp",))
        out = {}
        for name, (b, hq, hkv, s, d, entry, causal, kw) in CASES.items():
            s_local = s // WORLD
            q, k, v = (torch.from_numpy(x[:, :, rank * s_local:(rank + 1) * s_local]).contiguous()
                       for x in inputs(b, hq, hkv, s, d))
            fn = seq.ring_attention if entry == "ring" else seq.allgather_attention
            out[name] = fn(q, k, v, sp, causal=causal, **kw).numpy()
        meshes = {"default": pmesh.make_mesh(), "data 2": pmesh.make_mesh(data=2),
                  "model 1": pmesh.make_mesh(model=1)}
        out["meshes"] = {key: (tuple(m.mesh.shape), m.mesh_dim_names, m.mesh.tolist())
                         for key, m in meshes.items()}
        out["info"] = pmesh.host_local_mesh_info(meshes["data 2"])
        q, k, v = (torch.from_numpy(x) for x in inputs(*WORLD1))
        for causal in (True, False):
            out[f"world1 ring causal={causal}"] = seq.ring_attention(
                q, k, v, meshes["model 1"], axis="model", causal=causal).numpy()
        out["world1 allgather causal=True"] = seq.allgather_attention(
            q, k, v, meshes["model 1"], axis="model").numpy()
        results.put((rank, out))
        dist.destroy_process_group()
    except Exception:
        results.put((rank, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world():
    """{rank: that rank's results} from a spawned gloo world of 4. JAX's
    side of every case is computed (and cached) here while the ranks run."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, results)) for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for name in CASES:
            jax_sequence(name)
        jax_sequence(INTERPRET_CASE, interpret=True)
        for _ in range(WORLD):
            rank, out = results.get(timeout=TIMEOUT_S)
            got[rank] = out
    except queue_module.Empty:
        pytest.fail(f"the gloo world gave {len(got)} of {WORLD} results in {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
    errors = [o for o in got.values() if isinstance(o, str)]
    assert not errors, errors[0]
    return got


def gathered(world, name):
    return np.concatenate([world[r][name] for r in range(WORLD)], axis=2)


def jax_sequence(name, interpret=None):
    """JAX's result of a case on a 4-device "sp" mesh."""
    b, hq, hkv, s, d, entry, causal, kw = CASES[name]
    window = kw.get("window")
    if not causal and window is None:
        entry = "ring"  # both entry points compute the same attention: one JAX run serves
    return _jax_sequence((b, hq, hkv, s, d), entry, causal, window, interpret)


@functools.lru_cache(maxsize=None)
def _jax_sequence(shape, entry, causal, window, interpret):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flash_attention_cute_tpu.parallel import sequence as jseq

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    q, k, v = (jnp.asarray(x) for x in inputs(*shape))
    if entry == "ring":
        return np.asarray(jseq.ring_attention(q, k, v, mesh, causal=causal, interpret=interpret))
    return np.asarray(jseq.allgather_attention(q, k, v, mesh, causal=causal, window=window,
                                               interpret=interpret))


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_on_a_gloo_world_of_4(world, name):
    np.testing.assert_allclose(gathered(world, name), jax_sequence(name), rtol=0, atol=2e-5)


def test_partials_ring_matches_jax_pallas_partials(world):
    """JAX's kernel route (its Pallas partials in interpret mode) against
    the port's B4 partials."""
    want = jax_sequence(INTERPRET_CASE, interpret=True)
    np.testing.assert_allclose(gathered(world, INTERPRET_CASE), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("route", ["ring causal=True", "ring causal=False",
                                   "allgather causal=True"])
def test_world_of_one(world, route):
    import jax.numpy as jnp

    from flash_attention_cute_tpu.ops.reference import attention_reference

    q, k, v = (jnp.asarray(x) for x in inputs(*WORLD1))
    want = np.asarray(attention_reference(q, k, v, causal=route.endswith("True")))
    for r in range(WORLD):  # every rank is a ring of its own
        np.testing.assert_allclose(world[r][f"world1 {route}"], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["ring noncausal", "ring causal even", "ring causal odd",
                                  "ring gqa", "ring d320 causal", "ring d320 noncausal"])
def test_unrolled_ring_equals_the_distributed_one_bit_for_bit(world, name):
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    b, hq, hkv, s, d, entry, causal, kw = CASES[name]
    q, k, v = (torch.from_numpy(x) for x in inputs(b, hq, hkv, s, d))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' products, summed in their order
    try:
        out = seq.ring_attention_unrolled(q, k, v, WORLD, causal=causal, **kw).numpy()
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(out, gathered(world, name))


def test_unrolled_allgather_equals_the_distributed_one(world):
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    b, hq, hkv, s, d, entry, causal, kw = CASES["allgather window"]
    q, k, v = (torch.from_numpy(x) for x in inputs(b, hq, hkv, s, d))
    out = seq.allgather_attention_unrolled(q, k, v, WORLD, causal=causal, **kw).numpy()
    np.testing.assert_allclose(out, gathered(world, "allgather window"), rtol=0, atol=1e-6)


def test_fold_partials_matches_jax():
    import jax.numpy as jnp

    from flash_attention_cute_tpu.parallel.sequence import _fold_partials as jax_fold
    from flash_attention_cute_tpu_torch.parallel.sequence import _fold_partials

    rng = np.random.default_rng(3)
    shape = (2, 3, 40)
    m, m_c = (rng.uniform(-4, 30, shape).astype(np.float32) for _ in "mm")
    m[:, :, :5] = -np.inf  # no state yet
    m_c[:, :, 3:9] = -np.inf  # a chunk that hides the row
    l, l_c = (rng.uniform(0, 50, shape).astype(np.float32) for _ in "ll")
    l[:, :, :5] = 0.0
    l_c[:, :, 3:9] = 0.0
    acc, o_u = (rng.standard_normal(shape + (8,), dtype=np.float32) for _ in "ao")
    acc[:, :, :5] = 0.0
    o_u[:, :, 3:9] = 0.0
    args = (m, l, acc, m_c, l_c, o_u)
    got = _fold_partials(*(torch.from_numpy(x) for x in args))
    want = jax_fold(*(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_make_mesh_shapes(world):
    for r in range(WORLD):
        meshes = world[r]["meshes"]
        assert meshes["default"] == ((1, 4), ("data", "model"), [[0, 1, 2, 3]])
        assert meshes["data 2"] == ((2, 2), ("data", "model"), [[0, 1], [2, 3]])
        assert meshes["model 1"] == ((4, 1), ("data", "model"), [[0], [1], [2], [3]])
        assert world[r]["info"] == {"process_index": r, "process_count": WORLD,
                                    "local_coords": [(r // 2, r % 2)]}
