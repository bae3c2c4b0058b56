"""The port's kernel plain versions against the JAX package's kernels.

Each plain version in ``repro_torch/kernels/ref.py`` is held against the
JAX Pallas kernel it stands for (run with ``interpret=True``, as
``tests/test_kernels.py`` runs it on the CPU) and against the JAX oracle,
over window, softcap, T, gate, activation and zero scales.  Inputs are
made with numpy from a seed.  Tolerances: float32 throughout, 2e-5
absolute (different summation orders, same arithmetic).

The CUDA kernels themselves run only on the card: ``test_cuda_kernels_match
_plain_versions`` is marked ``gpu`` and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.glass_ffn import glass_ffn_block_sparse, glass_ffn_block_sparse_rowwise
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.kernels.ref import glass_ffn_ref as jax_glass_ffn_oracle
from repro_torch.kernels import ops
from repro_torch.kernels.ref import glass_ffn_ref, glass_ffn_rowwise_ref, paged_attention_ref

TOL = 2e-5
GLOBAL = 2**30


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pool_case(seed, B=2, T=3, K=2, G=2, hd=12, bs=8, num_blocks=9, lens=(5, 12), nb=4):
    """Random pool (garbage in every row, trash block 0 included), disjoint
    block lists per row (holes at trash), queries at ``lens``."""
    rng = np.random.RandomState(seed)
    ck = rng.randn(num_blocks, bs, K, hd).astype(np.float32)
    cv = rng.randn(num_blocks, bs, K, hd).astype(np.float32)
    q = rng.randn(B, T, K, G, hd).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_blocks))
    tab = np.zeros((B, nb), np.int32)
    off = 0
    for b, n in enumerate(lens):
        need = -(-(n + T) // bs)
        tab[b, :need] = ids[off : off + need]
        off += need
    return q, ck, cv, tab, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window,softcap", [(GLOBAL, None), (6, None), (GLOBAL, 30.0), (3, 12.0)])
@pytest.mark.parametrize("T", [1, 3])
def test_paged_attention_plain_matches_jax_kernel(window, softcap, T):
    q, ck, cv, tab, clen = _pool_case(0, T=T)
    want = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tab), jnp.asarray(clen),
        jnp.int32(window), softcap=softcap, interpret=True,
    )
    got = paged_attention_ref(_t(q), _t(ck), _t(cv), _t(tab), _t(clen), window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_paged_attention_plain_ignores_bucket_and_trash_bitwise():
    """A wider nb bucket (trash entries) and garbage in trash block 0 and in
    rows past each frontier change nothing, bitwise."""
    q, ck, cv, tab, clen = _pool_case(1, lens=(5, 12), nb=4)
    args = [_t(a) for a in (q, ck, cv, tab, clen)]
    base = paged_attention_ref(*args, GLOBAL)
    wide = np.zeros((tab.shape[0], 16), np.int32)
    wide[:, :4] = tab
    assert torch.equal(paged_attention_ref(args[0], args[1], args[2], _t(wide), args[4], GLOBAL), base)
    ck2, cv2 = ck.copy(), cv.copy()
    ck2[0], cv2[0] = 1e3, -1e3  # the trash block
    T, bs = q.shape[1], ck.shape[1]
    for b, n in enumerate(clen):  # rows past the frontier of each row
        for pos in range(n + T, tab.shape[1] * bs):
            blk = tab[b, pos // bs]
            if blk:
                ck2[blk, pos % bs], cv2[blk, pos % bs] = 7.0, -7.0
    got = paged_attention_ref(args[0], _t(ck2), _t(cv2), args[3], args[4], GLOBAL)
    assert torch.equal(got, base)


@pytest.mark.parametrize("window,softcap,lens,bs", [
    (GLOBAL, None, (543, 200), 16), (6, None, (5, 12), 8), (3, 12.0, (5, 12), 8),
])
def test_bf16_paged_limit_holds_the_jax_kernel_and_fails_a_wrong_block(window, softcap, lens, bs):
    """``chip_smoke.py`` holds the bf16 paged-attention kernel to its plain
    version elementwise within 8e-3 * (|ref| + attention over |v|).  The
    JAX kernel, whose online softmax rounds probabilities against a running
    max as the CUDA kernel does, stays within that limit; the plain version
    with one 16-key block of the long row read from the wrong block does
    not."""
    from chip_smoke import _paged_err

    nb = -(-(max(lens) + 1) // bs)
    q, ck, cv, tab, clen = _pool_case(4, T=1, K=2, G=2, hd=64, bs=bs, num_blocks=2 * nb + 1,
                                      lens=lens, nb=nb)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax_paged_attention(bf(q), bf(ck), bf(cv), jnp.asarray(tab), jnp.asarray(clen),
                               jnp.int32(window), softcap=softcap, interpret=True)
    args = [_t(q).bfloat16(), _t(ck).bfloat16(), _t(cv).bfloat16(), _t(tab), _t(clen)]
    ref = paged_attention_ref(*args, window, softcap=softcap)
    got = _t(want.astype(jnp.float32)).bfloat16()
    err, over = _paged_err(got, ref, args, window, softcap)
    assert over <= 1.0, (err, over)
    if bs == 16:
        wrong = args[3].clone()
        wrong[0, 3] = args[3][1, 0]
        bad = paged_attention_ref(*args[:3], wrong, args[4], window, softcap=softcap)
        assert _paged_err(bad, ref, args, window, softcap)[1] > 1.0


def _ffn_case(seed, B=4, d=64, m=256, bs=64, nbk=2, gated=True, rowwise=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, d).astype(np.float32)
    wu = (rng.randn(d, m) * 0.1).astype(np.float32)
    wg = (rng.randn(d, m) * 0.1).astype(np.float32) if gated else None
    wd = (rng.randn(m, d) * 0.1).astype(np.float32)
    rows = B if rowwise else 1
    idx = np.stack([np.sort(rng.permutation(m // bs)[:nbk]) for _ in range(rows)]).astype(np.int32)
    sc = np.ones((rows, nbk), np.float32)
    return x, wu, wg, wd, (idx if rowwise else idx[0]), (sc if rowwise else sc[0])


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_glass_ffn_plain_matches_jax_kernel_and_oracle(act, gated):
    x, wu, wg, wd, idx, sc = _ffn_case(2, gated=gated)
    j = lambda a: None if a is None else jnp.asarray(a)
    kern = glass_ffn_block_sparse(j(x), j(wu), j(wd), j(idx), j(wg), act=act, block_size=64,
                                  interpret=True)
    oracle = jax_glass_ffn_oracle(j(x), j(wu), j(wd), j(idx), j(wg), act=act, block_size=64)
    t = lambda a: None if a is None else _t(a)
    got = glass_ffn_ref(t(x), t(wu), t(wd), t(idx), t(wg), act=act, block_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("rowwise", [False, True])
def test_glass_ffn_plain_zero_scales_match_jax_kernel(rowwise):
    """A 0.0 scale drops its tile exactly: equal, bitwise, to the shorter
    list, and allclose to the JAX scaled kernel."""
    x, wu, wg, wd, idx, sc = _ffn_case(3, nbk=3, rowwise=rowwise)
    sc[..., 1] = 0.0
    j, t = jnp.asarray, _t
    jax_fn = glass_ffn_block_sparse_rowwise if rowwise else glass_ffn_block_sparse
    port_fn = glass_ffn_rowwise_ref if rowwise else glass_ffn_ref
    kern = jax_fn(j(x), j(wu), j(wd), j(idx), j(wg), block_scale=j(sc), block_size=64,
                  interpret=True)
    got = port_fn(t(x), t(wu), t(wd), t(idx), t(wg), block_scale=t(sc), block_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)
    keep = [0, 2]
    short = port_fn(t(x), t(wu), t(wd), t(idx[..., keep].copy()), t(wg),
                    block_scale=t(sc[..., keep].copy()), block_size=64)
    assert torch.equal(got, short)


def test_glass_ffn_rowwise_plain_matches_jax_kernel():
    x, wu, wg, wd, idx, sc = _ffn_case(4, B=3, rowwise=True)
    j, t = jnp.asarray, _t
    kern = glass_ffn_block_sparse_rowwise(j(x), j(wu), j(wd), j(idx), j(wg), block_size=64,
                                          interpret=True)
    got = glass_ffn_rowwise_ref(t(x), t(wu), t(wd), t(idx), t(wg), block_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)


def test_ops_send_cpu_tensors_to_the_plain_versions():
    """On CPU tensors the entry points are the plain versions (bitwise), and
    no kernel launch is counted; other devices raise."""
    ops.reset_launch_counts()
    q, ck, cv, tab, clen = (_t(a) for a in _pool_case(5))
    assert torch.equal(ops.paged_attention(q, ck, cv, tab, clen, GLOBAL),
                       paged_attention_ref(q, ck, cv, tab, clen, GLOBAL))
    x, wu, wg, wd, idx, sc = (_t(a) for a in _ffn_case(6))
    assert torch.equal(ops.glass_ffn(x, wu, wd, idx, wg, block_scale=sc, block_size=64),
                       glass_ffn_ref(x, wu, wd, idx, wg, block_scale=sc, block_size=64))
    ridx, rsc = idx[None].repeat(4, 1), sc[None].repeat(4, 1)
    assert torch.equal(ops.glass_ffn_rowwise(x, wu, wd, ridx, wg, block_scale=rsc, block_size=64),
                       glass_ffn_rowwise_ref(x, wu, wd, ridx, wg, block_scale=rsc, block_size=64))
    assert ops.launch_counts() == {"paged_attention": 0, "glass_ffn": 0, "glass_ffn_rowwise": 0,
                                   "flash_attention": 0, "local_stats": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.glass_ffn(x.to("meta"), wu, wd, idx, wg, block_size=64)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each CUDA kernel against its plain version (f32,
    2e-5), with a launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ops.reset_launch_counts()
    dev = "cuda"
    q, ck, cv, tab, clen = (_t(a).to(dev) for a in _pool_case(7))
    for window, softcap in [(GLOBAL, None), (3, 12.0)]:
        got = ops.paged_attention(q, ck, cv, tab, clen, window, softcap=softcap)
        want = paged_attention_ref(q, ck, cv, tab, clen, window, softcap=softcap)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    x, wu, wg, wd, idx, sc = (_t(a).to(dev) for a in _ffn_case(8, nbk=3))
    sc[1] = 0.0
    torch.testing.assert_close(ops.glass_ffn(x, wu, wd, idx, wg, block_scale=sc, block_size=64),
                               glass_ffn_ref(x, wu, wd, idx, wg, block_scale=sc, block_size=64),
                               atol=TOL, rtol=TOL)
    x, wu, wg, wd, idx, sc = (None if a is None else _t(a).to(dev)
                              for a in _ffn_case(9, gated=False, rowwise=True))
    torch.testing.assert_close(
        ops.glass_ffn_rowwise(x, wu, wd, idx, wg, block_scale=sc, act="gelu", block_size=64),
        glass_ffn_rowwise_ref(x, wu, wd, idx, wg, block_scale=sc, act="gelu", block_size=64),
        atol=TOL, rtol=TOL)
    assert ops.launch_counts() == {"paged_attention": 2, "glass_ffn": 1, "glass_ffn_rowwise": 1,
                                   "flash_attention": 0, "local_stats": 0}
