"""Batched serving driver: prefill once, reuse the cache, decode (counterpart
of ``repro/launch/serve.py``, every family, single device).

Four entry points, as in the reference:

* ``serve``: the production path. ``model.prefill_cache`` returns the
  decode cache already populated at pos = prompt_len, so decode starts at
  once (TTFT = one batched prefill; ``cache_setup_s`` is 0).
* ``serve_replay``: the prompt-replay baseline, which builds the cache by
  feeding the prompt token by token through ``model.decode``; the replay is
  reported as ``cache_setup_s``.
* ``serve_continuous``: continuous batching over a fixed ring of ``slots``
  decode slots. Requests of a Poisson arrival trace are admitted into free
  slots (a B=1 prefill whose cache tree is copied into slot b along dim 1)
  and evicted when done, while one decode step with per-slot (B,) positions
  serves the whole ring.
* ``serve_static``: the static-batching baseline on the same trace: groups
  of ``slots`` requests, a group starts when every member has arrived and
  the previous group has drained, and runs to its longest member.

Schedules are in decode-step clock units (one step = one batched decode;
prefill = 0 steps; idle waiting advances the clock); wall seconds are
reported beside them. Every host-clock reading follows a device
synchronization. Everything runs under ``torch.inference_mode()``; there is
no jit, so the reference's ``jit_cache_sizes`` metric has no counterpart
here and is absent from the metrics.

A MoE model routes each prompt row on its own at capacity
``moe._capacity(prompt_len)``, so choices past an expert's capacity are
dropped in the prefill, and each decode row's one token at capacity 8 (no
drop); ``exact_moe`` (a keyword, as in the reference; no CLI flag) sets
the capacity to tokens·K everywhere, the setting under which a prefill
equals the prompt's replay.

An MLA model (deepseek-v2) prefills on K4 under ``use_flash_kernel`` and
decodes against its latent cache in the latent space (the reference's
absorbed path, on tensor ops; K5 does not run). Prompts come from
``sample_batch`` in every family: an audio prompt (musicgen) is
``prompt_len`` frame embeddings, a vlm prompt (internvl2) is
``frontend_tokens`` patch embeddings followed by ``prompt_len -
frontend_tokens`` text tokens; decode feeds token ids from position
``prompt_len`` on. ``serve_replay`` feeds the prompt's ids, so it takes the
token families only.

The reference's ``warmup`` (a throwaway pass before timing, for its jit)
is not carried: the timings include first-call set-up. Weights are random,
from ``torch.Generator(device).manual_seed(seed)``, unless ``params`` are
given. Prompts come from ``sample_batch`` on
``TorchStream(seed + 1)`` (request r: its ``fold(r)``), sampling noise from
the chain ``nxt, draw = stream.split(2)`` on ``TorchStream(seed + 2)``; the
tests pass the reference's prompts and a stream over its keys instead.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --full --mode reuse --decode-kernel --batch 8 --prompt-len 512 \\
      --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --full --mode continuous --decode-kernel --batch 8 --requests 16 \\
      --prompt-len 256 --gen-len 64 --arrival-rate 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --full --flash-kernel --decode-kernel --batch 2 --prompt-len 8192 \\
      --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --device cpu --mode continuous --decode-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --full --decode-kernel --batch 4 --prompt-len 2048 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --full --flash-kernel --decode-kernel --batch 4 --prompt-len 2048 \\
      --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --full --flash-kernel --decode-kernel --batch 8 --prompt-len 512 \\
      --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --full --flash-kernel --decode-kernel --batch 2 --prompt-len 4096 \\
      --gen-len 64        # K4 with each layer's window; K6 on the tied table
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --device cpu --mode continuous --flash-kernel \\
      --decode-kernel                                   # reduced zamba2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --full --flash-kernel --decode-kernel --batch 4 --prompt-len 2048 \\
      --gen-len 64    # 60 routed experts, capacity 176 a row in the prefill
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --device cpu --flash-kernel --decode-kernel       # reduced qwen2-moe
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
      --full --flash-kernel --decode-kernel --batch 4 --prompt-len 2048 \\
      --gen-len 64        # frame-embedding prompts
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \\
      --full --flash-kernel --decode-kernel --batch 8 --prompt-len 512 \\
      --gen-len 64        # 256 patches + 256 text tokens; K6 on the tied table
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --device cpu --flash-kernel --decode-kernel       # reduced deepseek-v2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import (ModelCallConfig, build, sample_batch,
                                sample_ids)
from repro_torch.utils import rng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray      # (B, gen_len) generated ids (first from prefill)
    timings: dict           # prefill_s / cache_setup_s / decode_s / ttft_s / tok_per_s
    per_token_s: np.ndarray  # decode-loop wall seconds per step


@dataclasses.dataclass
class TraceResult:
    tokens: dict            # rid -> (gen_len_r,) np.int32
    requests: dict          # rid -> {arrival, start, finish} in step-clock units
    metrics: dict           # makespan_steps, tok_per_step, wall tok/s, p50/p99, ...


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(arch, *, reduced, dtype, decode_window, use_decode_kernel, seed,
           device, params, use_flash_kernel=False, exact_moe=False):
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model = build(cfg, ModelCallConfig(dtype=dtype,
                                       decode_window=decode_window,
                                       use_decode_kernel=use_decode_kernel,
                                       use_flash_kernel=use_flash_kernel,
                                       exact_moe=exact_moe))
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed))
    return cfg, model, params, device


def _noise(stream, shape, greedy, device):
    """Additive sampling noise and the next stream: zeros = greedy (the
    stream does not advance); Gumbel draws = categorical."""
    if greedy:
        return torch.zeros(shape, dtype=torch.float32, device=device), stream
    nxt, draw = stream.split(2)
    return draw.gumbel(shape, device), nxt


def poisson_trace(n_requests, arrival_rate, seed, gen_len):
    """Synthetic Poisson arrival trace in decode-step clock units.

    Returns (arrivals, gens): arrival step of each request (cumulative
    exponential inter-arrival times at ``arrival_rate`` requests/step) and its
    generation length, drawn in [max(1, gen_len//2), gen_len]. The port's
    own copy of the reference's numpy function.
    """
    gen = np.random.default_rng(seed)
    inter = gen.exponential(1.0 / arrival_rate, size=n_requests)
    arrivals = np.floor(np.cumsum(inter)).astype(np.int64)
    gens = gen.integers(max(1, gen_len // 2), gen_len + 1, size=n_requests)
    return arrivals, gens


def request_prompt(cfg, seed, rid, prompt_len, device):
    """Per-request B=1 prompt, deterministic in (seed, rid)."""
    return sample_batch(cfg, rng.TorchStream(seed + 1).fold(rid), 1,
                        prompt_len, device)


def insert_slot(cache, one, b):
    """Copy the B=1 cache tree ``one`` into slot ``b`` of the ring's cache
    tree, in place: every leaf is slot-major (batch at dim 1)."""
    for dst, src in zip(tree_leaves(cache), tree_leaves(one)):
        dst[:, b:b + 1].copy_(src)


def _decode_loop(model, params, cache, tok, pos, logits_shape, gen_len,
                 greedy, stream, device):
    """gen_len - 1 decode steps after the first token: (tokens (B, gen_len)
    on the host, per-step seconds)."""
    head = model.sample_head(params) if model.call.use_decode_kernel \
        else None
    zeros = torch.zeros(logits_shape, dtype=torch.float32, device=device)
    out, per_tok = [tok], []
    for _ in range(gen_len - 1):
        noise, stream = (zeros, stream) if greedy else \
            _noise(stream, logits_shape, False, device)
        _sync(device)
        ts = time.perf_counter()
        tok, cache = model.decode_sample(params, cache, tok, pos, noise,
                                         head)
        _sync(device)
        per_tok.append(time.perf_counter() - ts)
        pos += 1
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy(), per_tok


# --------------------------------------------------------------------------- #
# single-batch serving: cache reuse (production) vs prompt replay (baseline)
# --------------------------------------------------------------------------- #


def serve(arch: str, *, reduced=True, batch=4, prompt_len=32, gen_len=32,
          decode_window=0, dtype=torch.float32, greedy=True, seed=0,
          use_decode_kernel=False, use_flash_kernel=False,
          exact_moe=False, cache_len=None, prompt=None, params=None,
          stream=None, verbose=True, device=None) -> ServeResult:
    """Prefill once, decode from the returned cache: no prompt replay.

    The timings include first-call set-up, as a cold server start does.
    ``stream`` is the noise stream (default ``TorchStream(seed + 2)``).
    ``use_flash_kernel`` runs the prefill's attention on kernel K4 (the
    reference's ``ModelCallConfig`` knob, passed through); ``exact_moe``
    gives a MoE model's routing no capacity drops. The prefill SSD of an
    ssm or hybrid model runs on kernel K7 on the card (``ssm.ssd_chunked``
    decides from its inputs).
    """
    cfg, model, params, device = _setup(
        arch, reduced=reduced, dtype=dtype, decode_window=decode_window,
        use_decode_kernel=use_decode_kernel, seed=seed, device=device,
        params=params, use_flash_kernel=use_flash_kernel,
        exact_moe=exact_moe)
    with torch.inference_mode():
        if prompt is None:
            prompt = sample_batch(cfg, rng.TorchStream(seed + 1), batch,
                                  prompt_len, device)
        cache_len = cache_len or (prompt_len + gen_len)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill_cache(params, prompt, cache_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        stream = stream if stream is not None else rng.TorchStream(seed + 2)
        noise, stream = _noise(stream, logits.shape, greedy, device)
        tok = sample_ids(logits, noise, cfg.vocab_size)
        tokens, per_tok = _decode_loop(model, params, cache, tok, prompt_len,
                                       logits.shape, gen_len, greedy, stream,
                                       device)
    t_decode = float(sum(per_tok))
    timings = {"prefill_s": t_prefill, "cache_setup_s": 0.0,
               "decode_s": t_decode, "ttft_s": t_prefill,
               "tok_per_s": batch * max(gen_len - 1, 1) / max(t_decode, 1e-9)}
    if verbose:
        print(f"[serve] {arch}: prefill {t_prefill:.3f}s (TTFT), "
              f"decode {gen_len - 1} steps x{batch} = "
              f"{timings['tok_per_s']:.1f} tok/s")
    return ServeResult(tokens, timings, np.asarray(per_tok, np.float64))


def serve_replay(arch: str, *, reduced=True, batch=4, prompt_len=32,
                 gen_len=32, decode_window=0, dtype=torch.float32,
                 greedy=True, seed=0, cache_len=None, prompt=None,
                 params=None, stream=None, verbose=True, exact_moe=False,
                 device=None) -> ServeResult:
    """Differential baseline: build the decode cache by replaying the prompt
    token by token through ``model.decode`` (no decode kernels, no
    prefill).
    The replay loop is reported as ``cache_setup_s``, not as prefill. It
    feeds token ids, so the audio and vlm families (whose prompts carry
    embeddings) raise ValueError."""
    if get_config(arch, reduced=reduced).family in ("audio", "vlm"):
        raise ValueError(f"serve_replay feeds token ids; {arch}'s prompts "
                         f"carry embeddings")
    cfg, model, params, device = _setup(
        arch, reduced=reduced, dtype=dtype, decode_window=decode_window,
        use_decode_kernel=False, seed=seed, device=device, params=params,
        exact_moe=exact_moe)
    with torch.inference_mode():
        if prompt is None:
            prompt = sample_batch(cfg, rng.TorchStream(seed + 1), batch,
                                  prompt_len, device)
        cache_len = cache_len or (prompt_len + gen_len)
        toks = prompt["tokens"]
        _sync(device)
        t0 = time.perf_counter()
        cache = model.init_cache(batch, cache_len, device)
        logits = None
        for t in range(prompt_len):
            logits, cache = model.decode(params, cache, toks[:, t], t)
        _sync(device)
        t_setup = time.perf_counter() - t0

        stream = stream if stream is not None else rng.TorchStream(seed + 2)
        noise, stream = _noise(stream, logits.shape, greedy, device)
        tok = sample_ids(logits, noise, cfg.vocab_size)
        tokens, per_tok = _decode_loop(model, params, cache, tok, prompt_len,
                                       logits.shape, gen_len, greedy, stream,
                                       device)
    t_decode = float(sum(per_tok))
    timings = {"prefill_s": 0.0, "cache_setup_s": t_setup,
               "decode_s": t_decode, "ttft_s": t_setup,
               "tok_per_s": batch * max(gen_len - 1, 1) / max(t_decode, 1e-9)}
    if verbose:
        print(f"[serve-replay] {arch}: replay {t_setup:.3f}s (TTFT), "
              f"decode {gen_len - 1} steps x{batch} = "
              f"{timings['tok_per_s']:.1f} tok/s")
    return ServeResult(tokens, timings, np.asarray(per_tok, np.float64))


# --------------------------------------------------------------------------- #
# continuous vs static batching over a Poisson arrival trace
# --------------------------------------------------------------------------- #


def _trace_metrics(mode, slots, n_requests, gens, requests, per_step_s,
                   t_wall, t_prefill_total):
    total = int(sum(gens))
    makespan = max(rq["finish"] for rq in requests.values())
    delays = [rq["start"] - rq["arrival"] for rq in requests.values()]
    per = np.asarray(per_step_s, np.float64)
    return {
        "mode": mode, "slots": slots, "n_requests": n_requests,
        "total_tokens": total, "makespan_steps": int(makespan),
        "tok_per_step": total / max(makespan, 1),
        "decode_steps": len(per_step_s),
        "wall_s": t_wall, "prefill_s": t_prefill_total,
        "decode_s": float(per.sum()),
        "wall_tok_per_s": total / max(t_wall, 1e-9),
        "p50_step_s": float(np.percentile(per, 50)) if len(per) else 0.0,
        "p99_step_s": float(np.percentile(per, 99)) if len(per) else 0.0,
        "mean_queue_delay_steps": float(np.mean(delays)),
        "max_queue_delay_steps": int(np.max(delays)),
    }


def _trace_setup(arch, *, reduced, dtype, decode_window, use_decode_kernel,
                 use_flash_kernel, exact_moe, seed, device,
                 params, prompts, n_requests, arrival_rate, prompt_len,
                 gen_len):
    cfg, model, params, device = _setup(
        arch, reduced=reduced, dtype=dtype, decode_window=decode_window,
        use_decode_kernel=use_decode_kernel, seed=seed, device=device,
        params=params, use_flash_kernel=use_flash_kernel,
        exact_moe=exact_moe)
    arrivals, gens = poisson_trace(n_requests, arrival_rate, seed, gen_len)
    if prompts is None:
        prompts = [request_prompt(cfg, seed, r, prompt_len, device)
                   for r in range(n_requests)]
    return cfg, model, params, device, arrivals, gens, prompts


def serve_continuous(arch: str, *, reduced=True, slots=4, n_requests=8,
                     prompt_len=8, gen_len=8, arrival_rate=0.5,
                     decode_window=0, dtype=torch.float32, greedy=True,
                     seed=0, use_decode_kernel=False, use_flash_kernel=False,
                     exact_moe=False, params=None,
                     prompts=None, stream=None, verbose=True,
                     device=None) -> TraceResult:
    """Continuous batching: per-slot admission and eviction on a fixed
    decode ring. One decode step with per-slot (B,) positions serves every
    composition of in-flight requests; admission is a B=1 prefill whose
    cache tree is copied into slot b of the ring's cache along dim 1
    (``insert_slot``)."""
    cfg, model, params, device, arrivals, gens, prompts = _trace_setup(
        arch, reduced=reduced, dtype=dtype, decode_window=decode_window,
        use_decode_kernel=use_decode_kernel,
        use_flash_kernel=use_flash_kernel, exact_moe=exact_moe, seed=seed,
        device=device,
        params=params, prompts=prompts, n_requests=n_requests,
        arrival_rate=arrival_rate, prompt_len=prompt_len, gen_len=gen_len)
    cache_len = prompt_len + gen_len
    V = None
    toks = np.zeros((slots,), np.int32)
    pos = np.zeros((slots,), np.int32)
    active = np.zeros((slots,), bool)
    rid_of = np.full((slots,), -1)
    remaining = np.zeros((slots,), np.int64)
    out_tokens = {r: [] for r in range(n_requests)}
    requests = {r: {"arrival": int(arrivals[r]), "start": None,
                    "finish": None} for r in range(n_requests)}
    stream = stream if stream is not None else rng.TorchStream(seed + 2)
    next_req, n_done, clock = 0, 0, 0
    per_step_s, t_prefill_total = [], 0.0

    with torch.inference_mode():
        head = model.sample_head(params) if use_decode_kernel else None
        cache = model.init_cache(slots, cache_len, device)
        _sync(device)
        t_run0 = time.perf_counter()
        while n_done < n_requests:
            # --- admission: fill free slots with arrived requests -------- #
            for b in range(slots):
                if active[b] or next_req >= n_requests \
                        or arrivals[next_req] > clock:
                    continue
                r = next_req
                next_req += 1
                _sync(device)
                tp = time.perf_counter()
                logits1, c1 = model.prefill_cache(params, prompts[r],
                                                  cache_len)
                insert_slot(cache, c1, b)
                _sync(device)
                t_prefill_total += time.perf_counter() - tp
                V = logits1.shape[-1]
                noise, stream = _noise(stream, (1, V), greedy, device)
                t0 = int(sample_ids(logits1, noise, cfg.vocab_size)[0])
                out_tokens[r].append(t0)
                requests[r]["start"] = clock
                if gens[r] == 1:                      # done at admission
                    requests[r]["finish"] = clock
                    n_done += 1
                    continue
                toks[b], pos[b] = t0, prompt_len
                active[b], rid_of[b], remaining[b] = True, r, gens[r] - 1

            if not active.any():
                if next_req >= n_requests:
                    break          # the last request finished at admission
                # ring empty: jump the clock to the next arrival
                clock = max(clock + 1, int(arrivals[next_req]))
                continue

            # --- one batched decode step over the whole ring ------------- #
            noise, stream = _noise(stream, (slots, V), greedy, device)
            tok_in = torch.from_numpy(toks.copy()).to(device)
            pos_in = torch.from_numpy(pos.copy()).to(device)
            _sync(device)
            ts = time.perf_counter()
            tok_dev, cache = model.decode_sample(params, cache, tok_in,
                                                 pos_in, noise, head)
            new_toks = tok_dev.cpu().numpy()
            per_step_s.append(time.perf_counter() - ts)
            clock += 1
            for b in range(slots):
                if not active[b]:
                    continue
                r = rid_of[b]
                out_tokens[r].append(int(new_toks[b]))
                toks[b] = new_toks[b]
                pos[b] += 1
                remaining[b] -= 1
                if remaining[b] == 0:                 # eviction: free the slot
                    requests[r]["finish"] = clock
                    active[b], rid_of[b] = False, -1
                    n_done += 1
    t_wall = time.perf_counter() - t_run0
    metrics = _trace_metrics("continuous", slots, n_requests, gens, requests,
                             per_step_s, t_wall, t_prefill_total)
    if verbose:
        print(f"[serve-continuous] {arch}: {n_requests} reqs / {slots} slots: "
              f"{metrics['total_tokens']} tok in {metrics['makespan_steps']} "
              f"steps ({metrics['tok_per_step']:.2f} tok/step, "
              f"{metrics['wall_tok_per_s']:.1f} tok/s wall)")
    return TraceResult({r: np.asarray(t, np.int32)
                        for r, t in out_tokens.items()}, requests, metrics)


def serve_static(arch: str, *, reduced=True, slots=4, n_requests=8,
                 prompt_len=8, gen_len=8, arrival_rate=0.5, decode_window=0,
                 dtype=torch.float32, greedy=True, seed=0,
                 use_decode_kernel=False, use_flash_kernel=False,
                 exact_moe=False, params=None,
                 prompts=None, stream=None, verbose=True,
                 device=None) -> TraceResult:
    """Static-batching baseline on the SAME Poisson trace as
    ``serve_continuous``: requests are served in arrival-order groups of
    ``slots``; a group starts only when all members have arrived and the
    previous group has drained, and decodes to the longest member's length
    (short members pad)."""
    cfg, model, params, device, arrivals, gens, prompts = _trace_setup(
        arch, reduced=reduced, dtype=dtype, decode_window=decode_window,
        use_decode_kernel=use_decode_kernel,
        use_flash_kernel=use_flash_kernel, exact_moe=exact_moe, seed=seed,
        device=device,
        params=params, prompts=prompts, n_requests=n_requests,
        arrival_rate=arrival_rate, prompt_len=prompt_len, gen_len=gen_len)
    cache_len = prompt_len + gen_len
    out_tokens = {r: [] for r in range(n_requests)}
    requests = {r: {"arrival": int(arrivals[r]), "start": None,
                    "finish": None} for r in range(n_requests)}
    stream = stream if stream is not None else rng.TorchStream(seed + 2)
    clock = 0
    per_step_s, t_prefill_total = [], 0.0

    def group(members):
        return {k: torch.cat([prompts[r][k] for r in members], dim=0)
                for k in prompts[members[0]]}

    with torch.inference_mode():
        head = model.sample_head(params) if use_decode_kernel else None
        _sync(device)
        t_run0 = time.perf_counter()
        for g0 in range(0, n_requests, slots):
            grp = list(range(g0, min(g0 + slots, n_requests)))
            # pad the last group by repeating its final member (ignored)
            padded = grp + [grp[-1]] * (slots - len(grp))
            start = max(clock, max(int(arrivals[r]) for r in grp))
            _sync(device)
            tp = time.perf_counter()
            logits, cache = model.prefill_cache(params, group(padded),
                                                cache_len)
            _sync(device)
            t_prefill_total += time.perf_counter() - tp
            V = logits.shape[-1]
            noise, stream = _noise(stream, (slots, V), greedy, device)
            toks = sample_ids(logits, noise, cfg.vocab_size)
            first = toks.cpu().numpy()
            for i, r in enumerate(grp):
                out_tokens[r].append(int(first[i]))
                requests[r]["start"] = start
                requests[r]["finish"] = start + int(gens[r]) - 1
            mg = max(int(gens[r]) for r in grp)
            for t in range(mg - 1):
                noise, stream = _noise(stream, (slots, V), greedy, device)
                posv = torch.full((slots,), prompt_len + t,
                                  dtype=torch.int32, device=device)
                _sync(device)
                ts = time.perf_counter()
                toks, cache = model.decode_sample(params, cache, toks, posv,
                                                  noise, head)
                new = toks.cpu().numpy()
                per_step_s.append(time.perf_counter() - ts)
                for i, r in enumerate(grp):
                    if t + 1 < int(gens[r]):
                        out_tokens[r].append(int(new[i]))
            clock = start + mg - 1
    t_wall = time.perf_counter() - t_run0
    metrics = _trace_metrics("static", slots, n_requests, gens, requests,
                             per_step_s, t_wall, t_prefill_total)
    if verbose:
        print(f"[serve-static] {arch}: {n_requests} reqs / {slots} slots: "
              f"{metrics['total_tokens']} tok in {metrics['makespan_steps']} "
              f"steps ({metrics['tok_per_step']:.2f} tok/step, "
              f"{metrics['wall_tok_per_s']:.1f} tok/s wall)")
    return TraceResult({r: np.asarray(t, np.int32)
                        for r, t in out_tokens.items()}, requests, metrics)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--mode", default="reuse",
                    choices=["reuse", "replay", "continuous", "static"])
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size (reuse/replay) or decode slots (traces)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--decode-window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-greedy", action="store_true")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="decode attention on K5 and sampling on K6")
    ap.add_argument("--flash-kernel", action="store_true",
                    help="prefill attention on K4")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="Poisson arrivals per decode step (trace modes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    common = dict(reduced=not args.full, prompt_len=args.prompt_len,
                  gen_len=args.gen_len, decode_window=args.decode_window,
                  seed=args.seed, greedy=not args.no_greedy,
                  device=args.device)
    if args.mode == "replay":
        return serve_replay(args.arch, batch=args.batch, **common)
    kernels = dict(use_decode_kernel=args.decode_kernel,
                   use_flash_kernel=args.flash_kernel)
    if args.mode == "reuse":
        return serve(args.arch, batch=args.batch, **kernels, **common)
    fn = serve_continuous if args.mode == "continuous" else serve_static
    return fn(args.arch, slots=args.batch, n_requests=args.requests,
              arrival_rate=args.arrival_rate, **kernels, **common)


if __name__ == "__main__":
    main()
