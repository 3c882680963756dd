"""Shared checks of the port's model-family parity tests
(tests/test_torch_hybrid.py, tests/test_torch_qwen3.py): closeness at a
relative tolerance, bf16 caches, a teacher-forced decode from the
reference's cache, and ids under the near-tie rule. The tolerances are
argued in the test files."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import cache_from_jax
from repro_torch.kernels import ref
from repro_torch.utils.tree import tree_paths


def assert_close(got, want, tol, what):
    """max|got - want| <= tol·max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


def bf16_bits(x):
    """The 16-bit patterns of a torch or numpy/jax bf16 array."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def bf16_close(got_t, want, tol, what):
    """A bf16 cache written from fp32 values that differ by at most
    tol·max|value|: elementwise within that plus the two roundings to
    bf16, half an ulp each, <= 2^-8·|x| each."""
    g = got_t.float().numpy().astype(np.float64)
    w = np.asarray(want).astype(np.float32).astype(np.float64)
    assert g.shape == w.shape, what
    bound = tol * np.abs(w).max() + 2.0 ** -7 * np.maximum(np.abs(g),
                                                           np.abs(w))
    err = np.abs(g - w)
    assert np.all(err <= bound), \
        f"{what}: worst ratio {float((err / (bound + 1e-30)).max()):.3f}"


def to_jax_cache(cache):
    """The port's decode cache as the reference's (bf16 by its bits)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(bf16_bits(t).view(jnp.bfloat16))
        return jnp.asarray(t.numpy().copy())
    if isinstance(cache, dict):
        return {k: to_jax_cache(v) for k, v in cache.items()}
    return conv(cache)


def _held_layer_by_layer(tcache, want, g):
    """The dense family's cache (bf16 k and v, (L, B, C, Hk, hd)) held
    layer by layer, in the order ``decode`` writes it: to 1e-5 plus the
    two roundings, and to 1e-3 plus the roundings in the layers after one
    whose new K/V rounded to neighbouring bf16 values on the two sides
    (those layers' inputs attended to them, as the logits of such a step
    did). Returns whether any layer's new K/V rounded apart."""
    got = dict(tree_paths(tcache))
    flipped = False
    for i in range(got["k"].shape[0]):
        now = False
        for key in ("k", "v"):
            t, w = got[key][i], np.asarray(want[key])[i]
            bf16_close(t, w, 1e-3 if flipped else 1e-5, f"{key}[{i}] {g}")
            now |= not np.array_equal(bf16_bits(t), bf16_bits(w))
        flipped |= now
    return flipped


def teacher_forced(jm, tm, jp, tp, jprompt, S, G, pos_kind, layered=False,
                   max_flipped=None):
    """G steps from the reference's prefill cache; each step both models
    get the reference's greedy token and the port starts from the
    reference's cache, carried across by ``cache_from_jax`` (one step's
    rounding does not compound). Held each step: the updated cache (fp32
    leaves to 1e-5 of their largest values, bf16 leaves to 1e-5 plus the
    two roundings), and ``decode`` logits to 1e-5 of the largest with
    ``decode_sample``'s ids under the near-tie rule against the
    reference's. A step whose new K/V rounded to neighbouring bf16 values
    on the two sides (they are rounded before they are attended to) is
    held looser: logits to 1e-3, ids against the port's own logits; at
    most three quarters of the steps (``max_flipped``, where given) may be
    such steps. ``layered`` holds the dense cache layer by layer
    (``_held_layer_by_layer``), for models whose later layers attend to
    an earlier layer's new K/V in the same step. Returns the near-tie
    exceptions."""
    cfg = tm.cfg
    jl, jcache = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jprompt,
                                                             S + G)
    B = jl.shape[0]
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jdecode = jax.jit(jm.decode)
    zeros = torch.zeros((B, jl.shape[-1]))
    ties = n_flipped = 0
    for g in range(G):
        p = S + g
        tpos = p if pos_kind == "scalar" else torch.full((B,), p,
                                                         dtype=torch.int32)
        ttok = torch.from_numpy(np.asarray(tok).copy())
        tcache = cache_from_jax(jax.device_get(jcache), "cpu")
        tcache2 = cache_from_jax(jax.device_get(jcache), "cpu")
        jl, jcache = jdecode(jp, jcache, tok, jnp.int32(p))
        with torch.inference_mode():
            tl, tcache = tm.decode(tp, tcache, ttok, tpos)
            ids, _ = tm.decode_sample(tp, tcache2, ttok, tpos, zeros)
        want_cache = dict(jtree_paths(jax.device_get(jcache)))
        flipped = False
        if layered:
            flipped = _held_layer_by_layer(tcache, want_cache, g)
        for path, t in tree_paths(tcache) if not layered else ():
            w = want_cache[path]
            if t.dtype == torch.bfloat16:
                bf16_close(t, w, 1e-5, f"{path} {g}")
                flipped |= not np.array_equal(bf16_bits(t), bf16_bits(w))
            else:
                assert_close(t, w, 1e-5, f"{path} {g}")
        want = torch.from_numpy(
            np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], -1)).copy())
        if flipped:
            # the two sides attended to neighbouring bf16 values of the
            # step's own K/V: the logits agree to 1e-3, and the sampled ids
            # are held to the port's own logits
            assert_close(tl, jl, 1e-3, f"logits {g}")
            want = torch.argmax(tl[:, :cfg.vocab_size], -1)
            n_flipped += 1
        else:
            assert_close(tl, jl, 1e-5, f"logits {g}")
        t, bad = ref.near_tie_check(tl, ids, want, cfg.vocab_size)
        assert bad == 0, g
        ties += t
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    if max_flipped is None:
        max_flipped = G // 2 + G // 4
    assert n_flipped <= max_flipped, f"{n_flipped} of {G} steps flipped"
    return ties


def ids_held(tm, tp, prompt, got, want, pos0):
    """Hold ids ``got`` (B, G) to ``want`` under the near-tie rule on the
    port's plain logits, teacher-forced on ``want``; a row is compared while
    its earlier ids agree. Returns the near-tie exceptions."""
    cfg = tm.cfg
    ties = 0
    live = np.ones(got.shape[0], bool)
    with torch.inference_mode():
        lg, cache = tm.prefill_cache(tp, prompt, pos0 + got.shape[1])
        for g in range(got.shape[1]):
            rows = np.flatnonzero(live)
            t, bad = ref.near_tie_check(
                lg[rows], torch.from_numpy(got[rows, g]),
                torch.from_numpy(want[rows, g]), cfg.vocab_size)
            assert bad == 0, g
            ties += t
            live &= got[:, g] == want[:, g]
            lg, cache = tm.decode(tp, cache, torch.from_numpy(want[:, g]),
                                  pos0 + g)
    return ties
