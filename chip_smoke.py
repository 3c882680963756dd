"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, started together), holds each against its plain
PyTorch version on the card (K2, the per-leaf scaled step, bitwise over
ragged n, misaligned views and two launches past 2^31 elements), drives the
port's paths through ``repro_torch.launch.train.main`` at the full width of
qwen2-0.5b (the SAVIC round; local-adam; SAVIC with int8-stochastic
compression and error feedback; SAVIC with OASIS and half the clients
sampled; then the round's knobs at H = 4: per-client H_m from lognormal
step times with a depth-2 staleness FIFO beside the uniform round, the
adaptive controller with topk and error feedback, its knobs replayed by
``tests/_reference_controller.py``, and local-adam with the consistency
objective on half-labeled sequences and a client-resident final norm),
runs the pre-refactor round's per-leaf step (the momentum pass,
then ``ops.scaled_update_tree``: K2 once a leaf) on the Fig. 1 MLP, on the
reference kernels_fused bench's leaves and on full-width qwen2-0.5b, held
against the tree step and timed beside K1, holds the fused client loop
against the tree loop (also under H_m with the FIFO, and under the
controller), runs the paper's experiments through
``repro_torch.launch.paper`` (Fig. 1 at main_frac 0.5 for its five methods
on the tree and fused loops, Theorem 1's transient, §5.2's six points),
then drives the serving path through ``repro_torch.launch.serve`` at full
width (prefill-cache reuse with 63 decode steps on K5 and K6; continuous
batching over a ring of 8 slots; an 8192-token prompt at batch 2 prefilled
on K4, then 31 decode steps; then the SSM family: full-width mamba2-1.3b
prefilled at batch 4 from a 2048-token prompt through K7 into its
recurrent state, 63 decode steps on K6, and continuous batching of 16
requests on 8 slots), holds K6 at heads wider than 2048 (d = 2560, 8192),
holds the kernel paths against the plain ones teacher-forced (the K4
prefill against the chunked ``models/flash.py`` one, the K7 prefill against
``models.ssm._ssd_chunked``), and checks what comes out. Phase 9 holds
checkpoint and resume through ``train.main --ckpt``: savic through K1 at
full width cut to 2 layers, M = 4, 3 rounds against 2 + restore + 1 (9a;
cut from 24 layers, whose 17.84 GB saves took 125 s on the machine's 9p
disk, to make room for phase 17: 2 layers keep K1 on the (4, n) buffer
and every leaf kind at full width); two full-width 2-layer cases with
every optional state group between them, 4 rounds against 2 + 2 (9b, K3
in one); the final checkpoints byte for byte equal, save and
restore times and the host's memory printed; then ``launch/train_lm.py``'s
six methods and full-width savic (9c). It writes its checkpoints under
``.chip_smoke_ckpt/`` beside this file and removes the directory. Phase
10 drives the hybrid and qwen3-4b at full width and depth: zamba2-2.7b
served at batch 4 from a 2048-token prompt through K7 (its 54 mamba
layers), K4 (the 9 applications of its weight-tied attention block, d_head
80), K5 and K6, its prefill's device time split by kernel, the kernel
prefill held against the plain one and the K5/K6 decode against the plain
decode (10a); continuous batching of 16 requests on 8 slots, three held
against solo serving (10b); qwen3-4b served at batch 8 from a 512-token
prompt through K4, K5 and K6, held the same way (10c); savic on zamba2 cut
to 12 layers through ``train.main`` on K1, and fused against tree at 6
(10d); then K4-K7 against their plain versions and timed at these
shapes. Phase 11 drives gemma3-4b at full width and depth: served at
batch 2 from a 4096-token prompt through K4 at d_head 256 (its 34 layers:
29 with the 1024 window, 5 global), K5 (the window in each local layer's
bias) and K6 on the tied table (11a), the K4 prefill held against the
chunked plain one with the same per-layer windows and the K5/K6 decode
against the plain decode (11b), then K4 (global and windowed), K5 and K6
against their plain versions at its shapes and timed, SDPA beside K4 and
K5 with the backend it took (11c). Phase 12 drives qwen2-moe-a2.7b at full
width and depth (24 layers of 60 routed top-4 experts and a shared MLP;
53.33 GiB of fp32 weights): served at batch 4 from a 2048-token prompt
through K4, K5 and K6, each prompt row routed at capacity 176 with the
overflow dropped, its prefill's device time split by kernel and the
share of choices dropped per layer printed (12a); K4 held layer by layer
(the plain route's input to each layer through both routes) and the K4
prefill end to end, the K5/K6 decode teacher-forced, every layer's routing
recorded on both routes and every difference held as a near tie (12b);
continuous batching of 16 requests on 8 slots, three held against solo
serving (12c); K4, K5 and K6 against their plain versions at its shapes and
timed (12d). It starts by checking that the earlier phases left under 1
GiB allocated, and holds one full-width copy of the weights at a time.
Phase 13 drives multi-head latent attention on deepseek-v2-236b at full
width cut to 4 of its 60 layers (the dense prefix layer and 3 MoE layers
of 160 routed top-6 experts; 49.56 GiB of fp32 weights): served at batch
2 from a 2048-token prompt through K4 (its 4 layers' prefill at q/k width
192, V padded from 128) and K6 (the untied 102,400-row head), the decode
in the latent space on tensor ops (the reference's absorbed path), its
prefill's device time by kernel, the decode step's device and host times
and the share of choices dropped per MoE layer (13a); K4 held layer by
layer and end to end against the chunked plain route, the absorbed decode
against the naive one and K6 against the plain decode, every routing
difference a near tie (13b); continuous batching of 16 requests on 8
slots, three held against solo serving (13c); then musicgen-large (frame
embeddings, 13d) and internvl2-1b (256 patches before the text, the tied
table, 13e) at full width and depth through K4, K5 and K6, held as 11b;
K4 at MLA's and musicgen's shapes, K5 at musicgen's and K6 at
deepseek-v2's head against their plain versions and timed (13f). Phase 14
drives the mesh layer through ``train.main --mesh debug --mesh-shape 1x1``
at full-width qwen2-0.5b (savic, H 2, b 8, S 128, 2 rounds; the plan fixes
M = 1 and the run starts and destroys a 1-rank NCCL group): ``--mode
paper`` on the tree loop (14a) and ``--mode plain --use-fused-kernel``,
per-shard flatten, K1, unflatten on shard axes of extent 1 (14b), each
held bitwise against ``--mesh none --clients 1`` (losses, drifts, every
leaf of the final state), K1 launched 4 times on 14b's path; then it runs
``examples/quickstart_torch.py`` and
``examples/federated_heterogeneity_torch.py --rounds 3`` on the card (14c),
their losses finite. Phase 15 holds the dry run's cost model
(``repro_torch.launch.dryrun``, ``utils/cost.py``) against the card: two
child processes, each with a fake process group of its own, predict one
round of the 14a and 14b ``train.main`` runs (15a) while no timed phase
runs; the same runs then go on the card, once timed (each round's
arguments' bytes and CUDA-event time read around the round step) and once
under ``FlopCounterMode`` (15b): the FLOPs, K1's launches and the
arguments' bytes must equal the prediction's, and the peak and the
roofline round time are printed beside the measured ones as ratios. All
three take attention's training route, K4 + K4b (``layers._takes_k4``):
the dry run's fake CUDA tensors through the operators' fake kernels, and
the dry run and ``FlopCounterMode`` count both by their FLOP formulas
(``kernels.flash_attention.work`` and ``work_bwd``).
Phase 16 drives the mesh features on the 1×1 card mesh, each run held
bitwise against ``--mesh none --clients 1`` in every deterministic record
field (compression_err, wire_bytes and the controller's knobs among them)
and every leaf of the final state: ``--mode plain --use-fused-kernel``
with int8 + EF (16a: K1 4 and K3 28 launches on the rank's blocks) and
``--mode paper`` with top-k + EF; the controller with a FIFO of 2 and the
consistency objective at ``--labeled-frac 0.5``, 3 rounds (16b); ``--ckpt``
over 4 rounds on the fused loop at 2 layers (cut from 24 for time),
straight and as 2 rounds then a resume, the mesh's ``data.bin`` at rounds
2 and 4 byte for byte (sha256 over its chunks' sha256) the unsharded
run's, save and restore seconds, GB/s and the device peak during a save
printed (16c; under ``.chip_smoke_ckpt16/``, removed).
Phase 17 trains the families that were only served, through
``train.main --method savic --use-fused-kernel`` at full width (M = 2, H
= 2, b = 8, 2 rounds, fp32), depth cut where the card's 80 GB force it:
mamba2-1.3b at 36 of 48 layers (17a), qwen2-moe-a2.7b at 1 of 24 (17b, an
MoE layer), gemma3-4b at 6 of 34 (17c, its first global layer), musicgen-
large at 16 of 48 (17d), internvl2-1b at full depth with S = 384 (17e,
256 patches and 128 text tokens), and the benchmark's nemotron3-nano-
30b-a3b share (8 of 128 experts, 32,768 ids) at 13 of 52 layers (17i,
its 6 Mamba-2 layers at 8 groups of B/C); each launches K1 4 times (the
SSD of mamba2 and of nemotron's M layers also K7b once a layer a client's
local step and K7 twice, on the card's training route), every record
finite with loss > 0 and drift > 0, its
peak printed beside the prediction from savic's measured bytes a
parameter, and M·n (past 2^31 on 17a-17d). 17f holds the fused loop
against the tree loop for each family at a smaller depth (M = 2; the
fused state kept in host memory meanwhile),
17g runs mamba2 at 24 layers with int8 + EF (K3 once a leaf a round), 17h
qwen2-moe at 1 layer with ``--dtype bfloat16`` (bf16 compute on fp32
state: the fused loop, K1 4). Each phase's seconds are printed on a line
of their own. Any failed phase raises and the script exits non-zero.
Without a CUDA device, or without the rest of the repository beside it,
it exits non-zero before printing any result.

The second-to-last lines are one JSON object listing the kernels (launches
on the main path, error against the plain version (K4's over its fp32
cases, K7's over all its cases, K7b's at the mamba2 benchmark cell's and
phase 17's training shapes and at the nemotron cell's, whose 8 groups of
B/C reach it as per-head copies with dB and dC summed over each group's
heads, held there against the plain VJP at G groups), measured and least
possible times; K2's times are one per-leaf step over
full-width qwen2-0.5b's 14 leaves at M = 4) and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch import checkpoint as ckpt_lib  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PrecondConfig, engine  # noqa: E402
from repro_torch.core import preconditioner as PC  # noqa: E402
from repro_torch.data import (LMRoundLoader, TokenStream,  # noqa: E402
                              federated, main_class_partition)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_step as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quantize_update as qu  # noqa: E402
from repro_torch.kernels import scaled_update as su  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import paper  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.launch.roofline import (HBM_BYTES_PER_S,  # noqa: E402
                                         PEAK_FLOPS)
from repro_torch.models import (ModelCallConfig, sample_batch,  # noqa: E402
                                sample_ids)
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.flash import flash_attention_bshd  # noqa: E402
from repro_torch.models.ssm import broadcast_heads  # noqa: E402
from repro_torch.utils import rng  # noqa: E402
from repro_torch.utils.flatten import FlatLayout  # noqa: E402
from repro_torch.utils.tree import (tree_leaves, tree_map,  # noqa: E402
                                    tree_paths, tree_size)
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# the controller's numpy oracle (numpy only) and the MoE routing records
# (torch only), beside the tests
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _reference_controller as ref_ctrl  # noqa: E402
from _torch_moe_routing import RouteRecorder, hold_routing  # noqa: E402

FP32_FLOP_PER_S = PEAK_FLOPS["float32"]    # outside the tensor cores
DEV = torch.device("cuda", 0)
H_LOCAL = 2
K1_N = 1 << 20                     # row length of the kernel-vs-plain cases
BIG = (3, 716_000_001)             # M, n of the launch with M·n > 2^31
# K3 launches with M·n > 2^31: odd n (scalar path) and n % 4 == 0 (float4)
K3_BIG = ((3, 716_000_001), (4, 537_000_000))
EMBED = (4, 137_625_600)           # the embed.table leaf at M=4, full width
N_LEAVES = 14                      # parameter leaves of qwen2-0.5b
INT8_EF = ["--compression", "int8-stochastic", "--error-feedback"]
OASIS_HALF = ["--preconditioner", "oasis", "--participation", "0.5"]
# the round's knobs at full width, H = 4: lognormal step times at seed 0
# give H_m = (3, 4, 2, 3) (stragglers freeze mid-round) and a spread of 1.59
# (the controller's b_eff = 2, and at H_t = 1 three clients sit out)
H_KNOBS = 4
HET_ASYNC = ["--h-local", str(H_KNOBS), "--het-model", "lognormal",
             "--het-seed", "0", "--async-buffer", "2", "--staleness-weight",
             "polynomial"]
CONTROLLER = ["--h-local", str(H_KNOBS), "--controller", "--async-buffer",
              "2", "--het-model", "lognormal", "--het-seed", "0",
              "--compression", "topk", "--compression-k", "0.1",
              "--error-feedback"]
SEMI_PERSONAL = ["--objective", "consistency", "--labeled-frac", "0.5",
                 "--personalize", "final_norm"]
# serving: batch 8, prompt 512, 64 tokens (63 decode steps) at full width
SERVE = dict(batch=8, prompt_len=512, gen_len=64)
K5_MAIN = (8, 576, 2, 7, 64)       # B, C, Hk, rep, D of the decode steps
K5_PER_CALL = 2                    # K5 launches a call: partials, then merge
K5_MAIN_SPLITS = (32, 64, 96)      # split lengths timed beside the plan's
V_PAD, V_REAL, D_MODEL = 153_600, 151_936, 896
TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
             arrival_rate=0.5, seed=0)
# long-prompt prefill: batch 2, prompt 8192, 32 tokens (31 decode steps)
LONG = dict(batch=2, prompt_len=8192, gen_len=32)
K4_MAIN = (2, 8192, 14, 2, 64)     # B, S, H, Hk, D of the prefill's K4
K5_LONG = (2, 8224, 2, 7, 64)      # B, C, Hk, rep, D of its decode steps
K5_LONG_SPLITS = (64, 96, 128, 160)
# K4 against its plain version: (B, S, H, Hk, D, window, softcap, dtype)
K4_CASES = [(*K4_MAIN, 0, 0.0, torch.float32),
            (2, 2048, 8, 1, 64, 0, 0.0, torch.float32),        # MQA
            (2, 2048, 14, 2, 32, 0, 0.0, torch.float32),
            (2, 2048, 14, 2, 128, 0, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 16, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 100, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 0, 30.0, torch.float32),
            (*K4_MAIN, 0, 0.0, torch.bfloat16),
            (2, 1, 14, 2, 64, 0, 0.0, torch.float32),
            (2, 1000, 14, 2, 64, 0, 0.0, torch.float32),
            # S not a multiple of the 64-row tile, with D 32 / 128, a
            # window and softcap, and bf16
            (2, 8191, 14, 2, 64, 0, 0.0, torch.float32),
            (1, 2049, 14, 2, 128, 300, 30.0, torch.float32),
            (1, 1025, 14, 2, 32, 0, 0.0, torch.float32),
            (1, 4097, 14, 2, 64, 0, 0.0, torch.bfloat16),
            # D = 256 (gemma3's 256-thread, 32-key-tile instance): S not a
            # multiple of the tile, its window with softcap, bf16, and a D
            # of 160 that pads to 256
            (1, 4097, 8, 4, 256, 0, 0.0, torch.float32),
            (1, 2049, 8, 4, 256, 1024, 30.0, torch.float32),
            (1, 2049, 8, 4, 256, 0, 0.0, torch.bfloat16),
            (2, 2048, 8, 4, 160, 300, 0.0, torch.float32)]
# mamba2-1.3b serving: batch 4, prompt 2048, 64 tokens (63 decode steps)
MAMBA = dict(batch=4, prompt_len=2048, gen_len=64)
K7_MAIN = (4, 2048, 64, 64, 128, 256)   # B, S, H, P, N, Q of the prefill's K7
N_MAMBA_LAYERS = 48
MTRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
              arrival_rate=0.5, seed=0)
K7_ONE = (1, 256, 64, 64, 128, 256)     # the continuous-batching prefill's
# K7 against its plain version: (B, S, H, P, N, Q, A, shared B/C): the
# prefill's shape with one B/C group over the heads (head stride 0, as the
# model passes them) and per head; Q 64/128 x N 16/64 x P 32/128; one chunk
# (the continuous-batching prefill); A = -16 on every head (largest |cum|);
# B with head stride 0 beside a per-head C ("B": the per-head G path); one
# chunk with A = -16; the nemotron benchmark cell's call (b 2, S 4096, Q 128)
# with its 8 groups of B/C as per-head copies (``ssm.broadcast_heads``, as
# the training route passes them)
K7_NEMO = (2, 4096, 64, 64, 128, 128)
NEMO_GROUPS = 8
K7_CASES = [(*K7_MAIN, None, True), (*K7_MAIN, None, False),
            *[(2, 512, 8, P, N, Q, None, False) for Q in (64, 128)
              for N in (16, 64) for P in (32, 128)],
            (*K7_ONE, None, True),
            (*K7_MAIN, -16.0, True),
            (2, 512, 8, 64, 64, 128, None, "B"),
            (*K7_ONE, -16.0, True),
            (*K7_NEMO, None, NEMO_GROUPS)]
# K7b (K7's VJP, the backward of the SSD's training route) against its plain
# VJP and timed at the shapes the main path gives it, (B, S, H, P, N, Q, G):
# B/C one group, the mamba2 benchmark cell's call (b 2, S 2048, 8 chunks)
# and phase 17's mamba2 runs' (b 8, S 128: one chunk of 128); 8 groups as
# per-head copies, the nemotron benchmark cell's (b 2, S 4096, 32 chunks)
# B, S, H, Hk, D of the training cells' attention calls: qwen2-0.5b's and
# nemotron's (K4 + K4b on the training route, ``layers._takes_k4``)
K4B_CELL = (4, 1024, 14, 2, 64)
K4B_NEMO = (2, 4096, 32, 2, 128)
# (B, S, H, Hk, D, window, softcap) beside them: D 80 padded to 128 with a
# window and a softcap, S not a multiple of 64
K4B_CASES = [(*K4B_CELL, 0, 0.0), (*K4B_NEMO, 0, 0.0),
             (2, 1000, 8, 2, 80, 300, 30.0)]
K7B_CELL = (2, 2048, 64, 64, 128, 256, 1)
K7B_P17 = (8, 128, 64, 64, 128, 128, 1)
K7B_NEMO = (*K7_NEMO, NEMO_GROUPS)
U = 2.0 ** -24
# phase 10: the hybrid zamba2-2.7b (54 mamba2 layers, one weight-tied
# attention + MLP block after every 6th: 9 applications, d_head 80, 32 kv
# heads) and qwen3-4b (36 layers, GQA 32/8, d_head 128, qk-norm) at full
# width and depth
ZAMBA = dict(batch=4, prompt_len=2048, gen_len=64)
N_ZAMBA_LAYERS, N_ZAMBA_APPS = 54, 9
ZTRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
              arrival_rate=0.5, seed=0)
QWEN3 = dict(batch=8, prompt_len=512, gen_len=64)
N_QWEN3_LAYERS = 36
K4_ZAMBA = (4, 2048, 32, 32, 80)        # B, S, H, Hk, D: the shared block's
K4_QWEN3 = (8, 512, 32, 8, 128)
K5_ZAMBA = (4, 2112, 32, 1, 80)         # B, C, Hk, rep, D of the decode
K5_QWEN3 = (8, 576, 8, 4, 128)
K7_ZAMBA = (4, 2048, 80, 64, 64, 256)   # B, S, H, P, N, Q of the prefill
K7_ZAMBA_ONE = (1, 256, 80, 64, 64, 256)
# phase 11: gemma3-4b (34 layers: 29 local with a sliding window of 1024, 5
# global at 5, 11, 17, 23, 29; GQA 8/4 at d_head 256, qk-norm, GeGLU; a
# tied 262,144-row head scaled by 2560^-1/2) at full width and depth; its
# 4096-token prompt makes the window mask three quarters of a late row's
# keys, in the prefill and in every decode step
GEMMA = dict(batch=2, prompt_len=4096, gen_len=64)
N_GEMMA_LAYERS, GEMMA_GLOBAL, GEMMA_WINDOW = 34, (5, 11, 17, 23, 29), 1024
K4_GEMMA = (2, 4096, 8, 4, 256)         # B, S, H, Hk, D of the prefill's K4
K5_GEMMA = (2, 4160, 4, 2, 256)         # B, C, Hk, rep, D of the decode
# phase 12: qwen2-moe-a2.7b (24 layers, d 2048, MHA 16/16 of d_head 128 with
# QKV bias; 60 routed experts of width 1408, top 4, and a 5632-wide shared
# MLP in every layer; capacity factor 1.25; an untied 151,936-row head) at
# full width and depth: 14,315,587,584 parameters, 53.33 GiB in fp32
MOE_ARCH = "qwen2-moe-a2.7b"
MOE = dict(batch=4, prompt_len=2048, gen_len=64)
N_MOE_LAYERS = 24
MOE_TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
                 arrival_rate=0.5, seed=0)
K4_MOE = (4, 2048, 16, 16, 128)         # B, S, H, Hk, D of the prefill's K4
K5_MOE = (4, 2112, 16, 1, 128)          # B, C, Hk, rep, D of the decode
K5_MOE_RING = (8, 320, 16, 1, 128)      # the continuous ring's decode
MOE_HEAD = (153_600, 151_936, 2048, 2048 ** -0.5, 1.0)
# a token's first routing difference between two routes must have a top-K
# margin within this many times the largest router-probability difference
# of the tokens whose routing agreed (tests/_torch_moe_routing.py)
MOE_FLIP_FACTOR = 4.0
# phase 13: deepseek-v2-236b (MLA: q LoRA 1536, a 512-wide latent KV and one
# shared 64-wide rope key, 128 heads of nope 128 + rope 64, v 128; 160 routed
# experts of width 1536, top 6, two shared; one dense prefix layer of FFN
# width 12288; an untied 102,400-row head) at full width cut to 4 of its 60
# layers (the dense prefix layer and 3 MoE layers: 13,302,903,808
# parameters, 49.56 GiB in fp32; 60 layers are 878 GiB, 5 would be 64.35
# GiB, too near the card's 80 GB with the prefill's transients); then
# musicgen-large (audio: 48 layers, d 2048, MHA 32/32 of d_head 64, GeGLU,
# frame embeddings in, a 2048-row untied head) and internvl2-1b (vlm:
# qwen2-0.5b's 24 layers, 256 patch embeddings before the text, a tied
# 151,655-row table) at full width and depth
DSV2_ARCH = "deepseek-v2-236b-4l"
N_DSV2_LAYERS, DSV2_PARAMS = 4, 13_302_903_808
DSV2 = dict(batch=2, prompt_len=2048, gen_len=64)
DSV2_TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
                  arrival_rate=0.5, seed=0)
DSV2_CAPACITY = 96                      # int(2048 · 6 · 1.25 / 160), a row
DSV2_NAIVE_STEPS = 8                    # absorbed against naive decode
K4_MLA = (2, 2048, 128, 128, 192)       # B, S, H, Hk, D: q and k at 192
MLA_DV = 128                            # V padded from 128 to 192 for K4
DSV2_HEAD = (102_400, 102_400, 5120, 5120 ** -0.5, 1.0)
MUSICGEN_ARCH, INTERNVL_ARCH = "musicgen-large", "internvl2-1b"
MUSICGEN = dict(batch=4, prompt_len=2048, gen_len=64)
INTERNVL = dict(batch=8, prompt_len=512, gen_len=64)  # 256 patches + 256
N_MUSICGEN_LAYERS, N_INTERNVL_LAYERS = 48, 24
K4_MUSICGEN = (4, 2048, 32, 32, 64)
K4_INTERNVL = (8, 512, 14, 2, 64)
K5_MUSICGEN = (4, 2112, 32, 1, 64)      # B, C, Hk, rep, D of the decode
K5_INTERNVL = (8, 576, 2, 7, 64)
MUSICGEN_HEAD = (2048, 2048, 2048, 2048 ** -0.5, 1.0)
INTERNVL_HEAD = (153_600, 151_655, 896, 0.02, 896 ** -0.5)
# 10d: zamba2 training at full width, depth cut to 12 layers (two
# applications of the shared block; below 6 it would never run) and to 6
# for fused against tree (one application)
ARCH_Z12 = "zamba2-2.7b-12l"
# K2 against its plain version: n of every residue mod 4 around the float4
# width and at 2^20; one launch with n > 2^31 on aligned tensors (float4
# with a masked tail) and on views one float in (the scalar path)
K2_NS = (1, 3, 4, 5, 127, 128, 129, 1 << 20, (1 << 20) + 3)
K2_BIG = (1 << 31) + 3
# the per-leaf step's trees: the Fig. 1 MLP (192 -> 128 -> 10) at M = 10, the
# reference kernels_fused bench's leaves at M = 8; full-width qwen2-0.5b at
# M = 4 comes from the model
MLP_TREE = ({"w1": (192, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)},
            10)
BENCH_TREE = ({"w1": (256, 128), "b1": (128,), "w2": (128, 10),
               "b2": (10,)}, 8)
K2_STEP = dict(gamma=0.002, beta1=0.9, alpha=1e-2)   # Fig. 1's constants
# K6 at heads wider than 2048 (y staged in slices over d): (V, v_real, d,
# table scale, logit scale); V padded to a multiple of 2048
WIDE_HEADS = {"zamba2-2.7b": (32_768, 32_000, 2560, 2560 ** -0.5, 1.0),
              "gemma3-4b": (262_144, 262_144, 2560, 2560 ** -0.5, 1.0),
              "qwen3-4b": (153_600, 151_936, 2560, 2560 ** -0.5, 1.0),
              "deepseek-67b": (102_400, 102_400, 8192, 8192 ** -0.5, 1.0)}
# the paper's experiments on the card: fig1 at one main fraction, all five
# methods, tree and fused (K1) loops; fused against tree per round within
# 1e-5 of the loss (both run the same fp32 operations; K1 is bitwise its
# plain version) and 2 of the 1000 held-out examples
FIG1_FRAC = 0.5
FIG1_TOL = 1e-5


def main_argv(method, rounds, extra=()):
    return ["--arch", "qwen2-0.5b", "--method", method, "--use-fused-kernel",
            "--rounds", str(rounds), "--h-local", str(H_LOCAL), "--clients",
            "4", "--batch", "8", "--seq", "128", "--device", "cuda",
            *extra]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line(query="name,power.limit"):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def max_diff(a, b, chunk=1 << 26):
    """(max abs, max fp32 ulp) difference of two same-shape fp32 tensors,
    over flat chunks so that the int64 temporaries stay small at full width.
    Ulps come from a monotone int mapping of the bit patterns."""
    def key(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    a, b = a.reshape(-1), b.reshape(-1)
    err, ulps = 0.0, 0
    for lo in range(0, a.numel(), chunk):
        x, y = a[lo:lo + chunk], b[lo:lo + chunk]
        err = max(err, float((x - y).abs().max()))
        ulps = max(ulps, int((key(x) - key(y)).abs().max()))
    return err, ulps


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20):
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. It leaves
    out the host's time to issue each call (Python, allocation, launch),
    which back-to-back ``cuda_ms`` timing counts where a call's device work
    is shorter than its host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, replays) / calls
    del graph
    return ms


def k3_bytes(M, n):
    """Bytes K3 must move: read x, u and the row scales, write q and dec."""
    return M * n * (4 + 4 + 1 + 4) + 4 * M


k1_bytes = su.k1_bytes    # the one formula, shared with the dry run's cost


# --------------------------------------------------------------------------- #
# K1 inputs and the kernel-vs-plain comparison
# --------------------------------------------------------------------------- #

# (kind, schedule, clip, d, update_d, wd, h, s)
K1_CASES = [
    ("identity", "const", "max", None, False, 0.0, False, False),
    ("identity", "const", "max", None, False, 0.01, False, True),
    ("adam", "debias", "max", "global", False, 0.0, False, False),
    ("adam", "debias", "max", "local", True, 0.0, False, False),
    ("adam", "debias", "add", "local", True, 0.01, False, True),
    ("adam", "const", "max", "local", True, 0.0, True, False),
    ("adam", "debias", "add", "global", False, 0.01, False, True),
    ("rmsprop", "const", "max", "local", True, 0.0, False, True),
    ("rmsprop", "const", "add", "global", False, 0.0, False, False),
    ("rmsprop", "debias", "max", "local", True, 0.01, True, False),
    ("adagrad", "const", "max", "local", True, 0.0, False, False),
    ("adagrad", "const", "add", "local", True, 0.01, True, True),
    ("adagrad", "const", "max", "global", False, 0.0, False, True),
    ("oasis", "const", "max", "local", True, 0.0, True, False),
]


def k1_inputs(case, M, n, gen):
    kind, schedule, clip, dmode, update_d, wd, has_h, has_s = case
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    args = {"p": f(M, n), "m": f(M, n), "g": f(M, n), "d": None, "h": None,
            "t": torch.randint(0, 50, (M,), generator=gen, device=DEV,
                               dtype=torch.int32), "s": None}
    if dmode == "local":
        args["d"] = f(M, n) if kind == "oasis" else f(M, n).abs_()
    elif dmode == "global":
        args["d"] = f(n).abs_()
    if has_h:
        args["h"] = f(M, n) if kind == "oasis" else f(M, n).square_()
    if has_s:
        args["s"] = torch.rand((M,), generator=gen, device=DEV) * 0.9 + 0.1
    kw = dict(gamma=0.05, beta1=0.9, weight_decay=wd, alpha=1e-2,
              beta2=0.99, kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    return args, kw


ORDER = ("p", "m", "g", "d", "h", "t", "s")


def compare_case(case, M, n, gen):
    """Plain version on copies, kernel in place; returns (max abs, max ulp)
    over the outputs."""
    args, kw = k1_inputs(case, M, n, gen)
    want = ref.fused_step_ref(*(args[k] for k in ORDER), **kw)
    got = su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for w, g in zip(want, got):
        if w is not None:
            e, u = max_diff(w, g)
            err, ulps = max(err, e), max(ulps, u)
    return err, ulps


def big_case(gen):
    """One launch with M·n > 2^31 (64-bit offsets): local Adam with update,
    debias, clip scale and weight decay, n odd (scalar path). Compared on
    slices at the head of the first row and the tail of the last."""
    (M, n), K = BIG, 1 << 16
    case = ("adam", "debias", "add", "local", True, 0.01, False, True)
    args, kw = k1_inputs(case, M, n, gen)
    check(M * n > 2 ** 31, "big case is not above 2^31 elements")
    sl = {"head": (slice(0, 1), slice(0, K)),
          "tail": (slice(M - 1, M), slice(n - K, n))}
    saved = {name: {k: args[k][rows, cols].clone() for k in ("p", "m", "g",
                                                              "d")}
             for name, (rows, cols) in sl.items()}
    su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for name, (rows, cols) in sl.items():
        x = saved[name]
        want = ref.fused_step_ref(x["p"], x["m"], x["g"], x["d"], None,
                                  args["t"][rows], args["s"][rows], **kw)
        for w, k in zip(want, ("p", "m", "d")):
            e, u = max_diff(w, args[k][rows, cols])
            err, ulps = max(err, e), max(ulps, u)
    del args, saved
    torch.cuda.empty_cache()
    return M, n, err, ulps


def k1_main_shape(case, M, n, gen, plain_timing, iters=10):
    """K1 at the main path's shape, checked against its plain version and
    then timed. Returns (max abs, max ulp, ms, plain ms or None, bytes).

    The plain version runs row by row on (1, n) views of fresh inputs: every
    op is elementwise, so each row's values are those of one (M, n) call,
    and its temporaries stay one row wide. The kernel then runs once at
    (M, n), in place, and each of its rows is held against the plain one.
    The plain version is timed at (M, n) only where its temporaries (~4 more
    (M, n) buffers) fit beside the inputs (``plain_timing``)."""
    torch.cuda.empty_cache()
    args, kw = k1_inputs(case, M, n, gen)
    local_d = args["d"] is not None and args["d"].dim() == 2
    want = []
    for i in range(M):
        row = {k: (None if args[k] is None
                   else args[k] if k == "d" and not local_d
                   else args[k][i:i + 1]) for k in ORDER}
        want.append(ref.fused_step_ref(*(row[k] for k in ORDER), **kw))
    su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for i, outs in enumerate(want):
        for w, k in zip(outs, ("p", "m", "d")):
            if w is not None:
                e, u = max_diff(w, args[k][i:i + 1])
                err, ulps = max(err, e), max(ulps, u)
    del want
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: su.fused_step_flat(*(args[k] for k in ORDER), **kw),
                 iters)
    plain_ms = cuda_ms(lambda: ref.fused_step_ref(*(args[k] for k in ORDER),
                                                  **kw), 3) \
        if plain_timing else None
    nbytes = k1_bytes(M, n, case[3], case[6], case[4])
    del args
    torch.cuda.empty_cache()
    return err, ulps, ms, plain_ms, nbytes


# --------------------------------------------------------------------------- #
# K3 inputs and the kernel-vs-plain comparison
# --------------------------------------------------------------------------- #


def k3_inputs(M, n, gen, zero_rows=(), misalign=False):
    """x (M, n) with per-row magnitudes, U[0,1) draws u, scale absmax/127
    (0 on ``zero_rows``). ``misalign`` views x and u at an odd offset."""
    x = torch.randn((M, n), generator=gen, device=DEV)
    x.mul_(torch.rand((M, 1), generator=gen, device=DEV) * 10 + 1e-3)
    if zero_rows:
        x[list(zero_rows)] = 0.0
    u = torch.rand((M, n), generator=gen, device=DEV)
    if misalign:
        def shift(t):
            buf = torch.empty(t.numel() + 1, device=DEV)
            buf[1:] = t.reshape(-1)
            return buf[1:].view(M, n)
        x, u = shift(x), shift(u)
    return x, u, x.abs().amax(dim=1) / 127.0


def k3_diff(q, dec, wq, wdec):
    """(q mismatches, max abs, max ulp) of the kernel against its plain
    version."""
    bad = int((q != wq).sum())
    err, ulps = max_diff(dec, wdec)
    return bad, err, ulps


def k3_case(M, n, gen, zero_rows=(), misalign=False):
    x, u, s = k3_inputs(M, n, gen, zero_rows, misalign)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    return k3_diff(q, dec, wq, wdec)


def k3_big(M, n, gen, K=1 << 16):
    """One K3 launch with M·n > 2^31, held against the plain version on the
    head of the first row and the tail of the last."""
    check(M * n > 2 ** 31, "K3 big case is not above 2^31 elements")
    x, u, s = k3_inputs(M, n, gen)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    worst = (0, 0.0, 0)
    for rows, cols in ((slice(0, 1), slice(0, K)),
                       (slice(M - 1, M), slice(n - K, n))):
        wq, wdec = ref.quantize_update_ref(x[rows, cols].contiguous(),
                                           u[rows, cols].contiguous(),
                                           s[rows])
        d = k3_diff(q[rows, cols], dec[rows, cols], wq, wdec)
        worst = tuple(max(a, b) for a, b in zip(worst, d))
    del x, u, s, q, dec
    torch.cuda.empty_cache()
    return worst


def k3_embed(gen, iters=20):
    """K3 at the embed.table leaf's shape: checked against its plain
    version, then both timed. Returns (diff, ms, plain ms, bytes)."""
    M, n = EMBED
    x, u, s = k3_inputs(M, n, gen)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    diff = k3_diff(q, dec, wq, wdec)
    del q, dec, wq, wdec
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: qu.quantize_update_flat(x, u, s), iters)
    plain_ms = cuda_ms(lambda: ref.quantize_update_ref(x, u, s), 5)
    del x, u, s
    torch.cuda.empty_cache()
    return diff, ms, plain_ms, k3_bytes(M, n)



# --------------------------------------------------------------------------- #
# K2: against its plain version, and on its path (the per-leaf step)
# --------------------------------------------------------------------------- #


def k2_inputs(n, gen, alpha=K2_STEP["alpha"], misalign=False):
    """p, m, g ~ N(0, 1) and d = |N(0, 1)| with every fifth element 0 and
    every seventh under α² (the clip is hit), (n,) fp32; ``misalign`` views
    each one float into its buffer (not 16-byte aligned: the scalar path)."""
    off = int(misalign)
    x = [torch.randn(n + off, generator=gen, device=DEV)[off:]
         for _ in range(4)]
    d = x[3].abs_()
    d[::5] = 0.0
    d[1::7] = 0.25 * alpha ** 2
    return x


def k2_case(n, squared, beta1, alpha, gen, misalign=False):
    """(max abs, max ulp) of K2 against its plain version."""
    x = k2_inputs(n, gen, alpha, misalign)
    kw = dict(gamma=0.05, beta1=beta1, alpha=alpha, squared=squared)
    want = ref.scaled_update_ref(*x, **kw)
    got = su.scaled_update_flat(*x, **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for w, g in zip(want, got):
        e, u = max_diff(w, g)
        err, ulps = max(err, e), max(ulps, u)
    return err, ulps


def k2_big(gen, misalign, chunk=1 << 26):
    """One K2 launch past 2^31 elements, diffed against the plain version
    over the whole array chunk by chunk (the plain version's temporaries stay
    one chunk wide; 6 arrays of 8.6 GB)."""
    n = K2_BIG
    check(n > 2 ** 31, "K2 big case is not above 2^31 elements")
    torch.cuda.empty_cache()
    x = k2_inputs(n, gen, misalign=misalign)
    kw = dict(gamma=0.05, beta1=0.9, alpha=K2_STEP["alpha"], squared=True)
    got = su.scaled_update_flat(*x, **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for lo in range(0, n, chunk):
        want = ref.scaled_update_ref(*(t[lo:lo + chunk] for t in x), **kw)
        for w, g in zip(want, got):
            e, u = max_diff(w, g[lo:lo + chunk])
            err, ulps = max(err, e), max(ulps, u)
        del want
    del x, got
    torch.cuda.empty_cache()
    return n, err, ulps


def rand_tree(shapes, M, gen, positive=False):
    """{name: (M, *shape)} fp32 N(0, 1) leaves (|N(0, 1)| for a local D)."""
    tree = {k: torch.randn((M,) + tuple(shp), generator=gen, device=DEV)
            for k, shp in shapes.items()}
    if positive:
        tree = tree_map(torch.abs_, tree)
    return tree


def momentum_pass(mom, grads, beta1=K2_STEP["beta1"]):
    """m' = β₁m + g per leaf, the pre-refactor round's pass before K2."""
    return tree_map(lambda m, g: beta1 * m + g, mom, grads)


def per_leaf_step(params, mom, grads, d):
    """The pre-refactor round's scaled step: the momentum pass, then
    ``ops.scaled_update_tree`` (one K2 launch per leaf). Returns (params',
    m')."""
    mom2 = momentum_pass(mom, grads)
    return kops.scaled_update_tree(params, mom2, d, K2_STEP["gamma"],
                                   K2_STEP["alpha"]), mom2


def tree_step_check(params, mom2, d, newp):
    """The per-leaf step's params against the port's tree step p − γ·(m'/D̂)
    (``preconditioner.precondition``, the engine's order), element by
    element within 2⁻²¹·(|p'| + |γm'/D̂|): (γ·m')/D̂ and γ·(m'/D̂) each round
    twice, within 2⁻²³|γm'/D̂| of the exact step, and p − u once more, so
    the two differ by at most 2⁻²²|u| + 2⁻²³|p'|; the bound is twice that.
    Returns (elements beyond the bound, worst share of the bound)."""
    pc = PrecondConfig(kind="adam", alpha=K2_STEP["alpha"])
    bad, worst = 0, 0.0
    for k in params:
        upd = K2_STEP["gamma"] * PC.precondition(pc, {"d": d[k]}, mom2[k])
        want = params[k] - upd
        tol = 2.0 ** -21 * (want.abs() + upd.abs())
        diff = (newp[k] - want).abs()
        bad += int((diff > tol).sum())
        worst = max(worst, float((diff / tol.clamp_min(1e-38)).max()))
        del upd, want, tol, diff
    return bad, worst


def k2_path(name, shapes, M, gen):
    """K2 on the per-leaf step of one tree: the step (K2's count set to 0
    just before and read just after), held against the tree step, then
    timed (CUDA events, 10 steps): K2 alone (one launch a
    leaf on prepared inputs), its plain version, the whole per-leaf step
    (momentum pass, zeros, K2), and K1 (``fused_local_step``) on the same
    state flattened to (M, n) with a global D (client 0's) and with the
    local D. Returns a dict of the results."""
    params, mom, grads = (rand_tree(shapes, M, gen) for _ in range(3))
    d = rand_tree(shapes, M, gen, positive=True)
    su.scaled_update_flat.launches = 0
    newp, mom2 = per_leaf_step(params, mom, grads, d)
    launches = su.scaled_update_flat.launches
    torch.cuda.synchronize()
    check(launches == len(shapes), f"K2 launched {launches} times on "
          f"{name}, expected {len(shapes)} (one a leaf)")
    bad, worst = tree_step_check(params, mom2, d, newp)
    del newp
    n = sum(int(np.prod(s)) for s in shapes.values())
    out = {"name": name, "M": M, "n": n, "leaves": len(shapes), "bad": bad,
           "worst": worst, "launches": launches}
    torch.cuda.empty_cache()
    out["step_ms"] = cuda_ms(lambda: per_leaf_step(params, mom, grads, d),
                             10)
    flats = [(params[k].reshape(-1), torch.zeros_like(mom2[k]).reshape(-1),
              mom2[k].reshape(-1), d[k].reshape(-1)) for k in params]
    kw = dict(gamma=K2_STEP["gamma"], beta1=0.0, alpha=K2_STEP["alpha"])
    out["ms"] = cuda_ms(lambda: [su.scaled_update_flat(*f, **kw)
                                 for f in flats], 10)
    out["plain_ms"] = cuda_ms(lambda: [ref.scaled_update_ref(*f, **kw)
                                       for f in flats], 3)
    del flats, mom2
    torch.cuda.empty_cache()
    layout = FlatLayout.for_tree(params, batch_dims=1)
    bufs = {}
    for key, tree in (("p", params), ("m", mom), ("g", grads), ("d", d)):
        bufs[key] = layout.flatten(tree, batch_dims=1)
        tree.clear()                         # the flat copy replaces it
    del params, mom, grads, d
    torch.cuda.empty_cache()
    k1kw = dict(gamma=K2_STEP["gamma"], beta1=K2_STEP["beta1"],
                alpha=K2_STEP["alpha"], kind="adam")
    dg = bufs["d"][0].clone()
    out["k1_global_ms"] = cuda_ms(lambda: kops.fused_local_step(
        bufs["p"], bufs["m"], bufs["g"], dg, **k1kw), 10)
    out["k1_local_ms"] = cuda_ms(lambda: kops.fused_local_step(
        bufs["p"], bufs["m"], bufs["g"], bufs["d"], **k1kw), 10)
    del bufs, dg
    torch.cuda.empty_cache()
    # K2 moves p, m, g, d in and p', m' out: 24 bytes an element
    out["bytes"] = 24 * M * n
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def print_k2_path(r):
    print(f"[chip_smoke] K2 per-leaf step on {r['name']} (M={r['M']}, "
          f"n={r['n']}, {r['leaves']} leaves): against the tree step "
          f"p - g*(m'/D): {r['bad']} elements beyond 2^-21(|p'|+|u|), "
          f"worst at {r['worst']:.3f} of it; K2 alone {r['ms']:.4f} ms "
          f"({r['leaves']} launches), plain {r['plain_ms']:.4f} ms, whole "
          f"per-leaf step {r['step_ms']:.4f} ms, K1 global D "
          f"{r['k1_global_ms']:.4f} ms, K1 local D {r['k1_local_ms']:.4f} "
          f"ms, K2 bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e9:.3f} GB),"
          f" achieved {r['bytes'] / r['ms'] / 1e6:.1f} GB/s", flush=True)
    check(r["bad"] == 0, f"K2's per-leaf step differs from the tree step on "
          f"{r['name']}")


# --------------------------------------------------------------------------- #
# the paper's experiments (launch/paper.py)
# --------------------------------------------------------------------------- #


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def profile_fig1_round(method, fused, data, parts):
    """One steady Fig. 1 round (after a warm-up round) under the profiler:
    (kernel launches, device busy ms, wall ms)."""
    step, state, loader, _, _ = paper.fig1_setup(
        FIG1_FRAC, method, device=DEV, data=data, parts=parts,
        use_fused_kernel=fused)
    streams = paper.default_streams(0)
    for r in range(2):
        nb = paper.to_device(loader.round_batch(paper.FIG1["h_local"]), DEV)
        torch.cuda.synchronize()
        if r == 0:
            state, met = step(state, nb, streams(r))
            float(met["loss"])
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, met = step(state, nb, streams(r))
            float(met["loss"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return sum(e.count for e in kernels), busy, wall


def paper_phase():
    """fig1 at main_frac 0.5 for the five methods, 25 rounds, on the tree
    loop and on the fused loop (K1); thm1's transient case and sec52's six
    points on the fused loop, through ``launch/paper.py``. Every count is
    set to 0 just before a run and read just after."""
    data = paper.fig1_data(0)
    parts = main_class_partition(data.y[:-paper.FIG1["ntest"]],
                                 paper.FIG1["clients"], FIG1_FRAC, seed=0)
    H, R = paper.FIG1["h_local"], paper.FIG1["rounds"]
    rows = {}
    for fused in (False, True):
        su.fused_step_flat.launches = 0
        t0 = time.perf_counter()
        rows[fused] = {m: paper.fig1_run(FIG1_FRAC, m, device=DEV, data=data,
                                         parts=parts, use_fused_kernel=fused)
                       for m in paper.FIG1_METHODS}
        k1 = su.fused_step_flat.launches
        loop = "fused (K1)" if fused else "tree"
        want = len(paper.FIG1_METHODS) * R * H if fused else 0
        check(k1 == want, f"fig1 {loop}: K1 launched {k1} times, expected "
              f"{want}")
        print(f"[chip_smoke] fig1 main_frac {FIG1_FRAC}, {loop} loop: "
              f"{time.perf_counter() - t0:.1f} s for 5 methods x {R} rounds,"
              f" K1 launches {k1} ({H} a round)", flush=True)
        for m, rs in rows[fused].items():
            loss = [r["metrics"]["loss"] for r in rs]
            acc = [r["metrics"]["test_acc"] for r in rs]
            wall = [r["metrics"]["wall_s"] * 1e3 for r in rs[1:]]
            check(all(finite(v) for v in loss + acc), f"fig1 {m}: "
                  f"non-finite results")
            check(loss[-1] < loss[0], f"fig1 {m} ({loop}): round-{R - 1} "
                  f"loss {loss[-1]} is not below round 0's {loss[0]}")
            print(f"[chip_smoke]   {m}: loss {loss[0]:.4f} -> {loss[-1]:.4f}"
                  f", test acc {acc[-1]:.3f}; round wall (rounds 1-{R - 1})"
                  f" median {pct(wall, 50):.2f} ms, p90 {pct(wall, 90):.2f}"
                  f" ms; round 0 {rs[0]['metrics']['wall_s'] * 1e3:.1f} ms",
                  flush=True)
        summ = paper.summary("fig1", [r for rs in rows[fused].values()
                                      for r in rs])
        print(f"[chip_smoke]   summary ({loop}): {json.dumps(dict(summ))}",
              flush=True)
    worst = 0.0
    for m in paper.FIG1_METHODS:
        for a, b in zip(rows[True][m], rows[False][m]):
            la, lb = a["metrics"]["loss"], b["metrics"]["loss"]
            worst = max(worst, abs(la - lb) / abs(lb))
            check(abs(a["metrics"]["test_acc"] - b["metrics"]["test_acc"])
                  <= 2 / paper.FIG1["ntest"] + 1e-6, f"fig1 {m}: fused and "
                  f"tree test accuracy differ")
    print(f"[chip_smoke]   fused against tree: worst per-round loss "
          f"difference {worst:.3e} of the loss (bound {FIG1_TOL})",
          flush=True)
    check(worst <= FIG1_TOL, "fig1: fused and tree losses differ")
    for m in ("Adam global", "OASIS local"):
        for fused in (False, True):
            n_k, busy, wall = profile_fig1_round(m, fused, data, parts)
            print(f"[chip_smoke]   one traced fig1 round, {m}, "
                  f"{'fused' if fused else 'tree'}: {n_k} kernel launches, "
                  f"device busy {busy:.2f} ms of {wall:.2f} ms "
                  f"({busy / wall:.1%})", flush=True)
    for exp, argv, want in (
            ("thm1", ["--experiment", "transient"], 40 * 4),
            ("sec52", [], len(paper.SEC52_POINTS) * paper.SEC52["rounds"]
             * paper.SEC52["h_local"])):
        su.fused_step_flat.launches = 0
        t0 = time.perf_counter()
        out = paper.main(["--exp", exp, "--device", "cuda",
                          "--use-fused-kernel", *argv])[exp]
        k1 = su.fused_step_flat.launches
        vals = [v for r in out["rows"] for v in r["metrics"].values()]
        check(all(finite(float(v)) for v in vals), f"{exp}: non-finite rows")
        check(k1 == want, f"{exp}: K1 launched {k1} times, expected {want}")
        print(f"[chip_smoke] {exp} ({' '.join(argv) or 'six points'}), "
              f"fused loop: {time.perf_counter() - t0:.1f} s, K1 launches "
              f"{k1}, summary {json.dumps(out['summary'])}", flush=True)

# --------------------------------------------------------------------------- #
# K5 and K6 inputs and the kernel-vs-plain comparisons
# --------------------------------------------------------------------------- #


def k5_inputs(B, C, Hk, rep, D, gen, one_valid=False, window=0):
    """q fp32, k/v bf16 cache, and a causal bias at a random position per
    row (``one_valid``: every position but that one masked; ``window``: and
    every position ``window`` or more before it, as a local layer's)."""
    q = torch.randn((B, Hk * rep, D), generator=gen, device=DEV)
    k = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    pos = torch.randint(0, C, (B,), generator=gen, device=DEV)
    idx = torch.arange(C, device=DEV)
    ok = idx[None] == pos[:, None] if one_valid else idx[None] <= pos[:, None]
    if window:
        ok &= pos[:, None] - idx[None] < window
    return q, k, v, torch.where(ok, 0.0, -1e30).float().contiguous()


def k5_case(B, C, Hk, rep, D, cap, gen, one_valid=False, at=None,
            window=0):
    """(max abs error, its bound 1e-5·max|v|) of K5 against its plain
    version. ``at``: every position but ``at`` masked in every row."""
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen, one_valid, window)
    if at is not None:
        bias.fill_(-1e30)
        bias[:, at] = 0.0
    want = ref.decode_attention_ref(q, k, v, bias, softcap=cap)
    got = ds.decode_attention(q, k, v, bias, softcap=cap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bound = 1e-5 * float(v.float().abs().max())
    del q, k, v, bias, want, got
    return err, bound


def k5_bytes(B, C, Hk, rep, D):
    """Bytes K5 must move: read q, k, v and bias, write out."""
    H = Hk * rep
    return 4 * B * H * D + 2 * 2 * B * C * Hk * D + 4 * B * C + 4 * B * H * D


# the heads K6 samples from: (V, v_real, d, table scale, logit scale) of
# qwen2-0.5b's tied table and mamba2-1.3b's untied head
QWEN_HEAD = (V_PAD, V_REAL, D_MODEL, 0.02, D_MODEL ** -0.5)
MAMBA_HEAD = (51_200, 50_280, 2048, 2048 ** -0.5, 1.0)


def k6_inputs(B, gen, greedy, head=QWEN_HEAD):
    V, _, d, tscale, _ = head
    y = torch.randn((B, d), generator=gen, device=DEV)
    table = torch.randn((V, d), generator=gen, device=DEV) * tscale
    noise = torch.zeros((B, V), device=DEV) if greedy else \
        rng.gumbel_from_uniform(torch.rand((B, V), generator=gen,
                                           device=DEV))
    return y, table, noise


def k6_case(B, greedy, gen, dup=None, pad=False, head=QWEN_HEAD):
    """K6 against its plain version under the near-tie rule. ``dup``: two
    table rows made identical and best for row 0 (the lower index must
    win); ``pad``: a padded id that would win row 1 if it were not masked.
    Returns (exceptions, violations, max abs difference of the winning
    logit)."""
    _, v_real, _, _, scale = head
    y, table, noise = k6_inputs(B, gen, greedy, head)
    if dup:
        table[dup[0]] = table[dup[1]] = y[0] / y[0].norm() * 5.0
    if pad:
        table[v_real + 9] = y[1] / y[1].norm() * 50.0
    logits = ref.decode_sample_logits(y, table, noise, scale=scale,
                                      v_real=v_real)
    want, wbest = ref.decode_sample_ref(y, table, noise, scale=scale,
                                        v_real=v_real, return_best=True)
    got, best = ds.decode_sample(y, table, noise, scale=scale, v_real=v_real,
                                 return_best=True)
    torch.cuda.synchronize()
    ties, bad = ref.near_tie_check(logits, got, want, v_real)
    err = float((best - wbest).abs().max())
    if dup:
        check(int(got[0]) == dup[0] == int(want[0]),
              f"K6 duplicated rows {dup}: got id {int(got[0])}")
    if pad:
        check(int(got.max()) < v_real, "K6 chose a padded id")
    del y, table, noise, logits
    return ties, bad, err


def k6_bytes(B, v_real=V_REAL, d=D_MODEL):
    """Bytes K6 must move: the real table rows, the real noise columns and
    y, and the ids written."""
    return 4 * (v_real * d + B * v_real + B * d + B)


def sdpa_backend(fn, calls=3):
    """(backend, name of its longest CUDA kernel) of ``calls`` traced calls
    of ``fn``, an SDPA call: "flash", "efficient" (the memory-efficient
    kernel), "cudnn" or "math" (GEMMs and a softmax), by that name; "not
    traced" where the profiler recorded no kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted(profile_serve._device_events(prof),
                 key=lambda e: -e.self_device_time_total)
    names = " ".join(e.key.lower() for e in evs)
    del prof
    if not evs:
        return "not traced", ""
    kind = ("cudnn" if "cudnn" in names else "flash" if "flash" in names
            else "efficient" if "fmha" in names or "efficient" in names
            else "math")
    return kind, evs[0].key[:70]


def time_k5(shape, gen, splits=()):
    """K5 at ``shape`` (B, C, Hk, rep, D): CUDA-event times of the kernel
    wrapper (its two launches), its plain version and SDPA (the bias as
    mask over fp32 k/v, GQA), each timed back to back as every kernel is
    (``ms``: where a call's host work outlasts its device work, the host
    sets it) and as device time (``device_ms``, ``graph_ms``); the
    wrapper's two times with its plan swapped for each split length in
    ``splits`` and the plan's own (``split_ms``: {split: (ms, device_ms)});
    and its bound."""
    B, C, Hk, rep, D = shape
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen)
    q4 = q[:, :, None, :]
    kf = k.float().transpose(1, 2).contiguous()      # (B, Hk, C, D)
    vf = v.float().transpose(1, 2).contiguous()
    mask = bias[:, None, None, :]
    lib = F.scaled_dot_product_attention(q4, kf, vf, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    check(float((lib - ref.decode_attention_ref(q, k, v, bias)).abs().max())
          <= 1e-4, "SDPA does not compute K5's function")
    fns = {"": (lambda: ds.decode_attention(q, k, v, bias), 200),
           "plain_": (lambda: ref.decode_attention_ref(q, k, v, bias), 100),
           "library_": (lambda: F.scaled_dot_product_attention(
               q4, kf, vf, attn_mask=mask, enable_gqa=True), 200)}
    k5 = {}
    for key, (fn, iters) in fns.items():
        k5[key + "ms"] = cuda_ms(fn, iters)
        k5[key + "device_ms"] = graph_ms(fn)
    plan = ds.attention_plan
    k5["plan"], k5["split_ms"] = plan(B, Hk, C)[0], {}
    try:
        for split in sorted({k5["plan"], *splits}):
            ds.attention_plan = lambda B_, Hk_, C_, s=split: (s, -(-C_ // s))
            k5["split_ms"][split] = (cuda_ms(fns[""][0], 200),
                                     graph_ms(fns[""][0]))
    finally:
        ds.attention_plan = plan
    k5["library_backend"] = sdpa_backend(fns["library_"][0])
    k5["bytes"] = k5_bytes(B, C, Hk, rep, D)
    k5["bound_ms"] = k5["bytes"] / HBM_BYTES_PER_S * 1e3
    del q, k, v, bias, kf, vf, lib
    torch.cuda.empty_cache()
    return k5


def time_k6(gen, B=SERVE["batch"], head=QWEN_HEAD):
    """K6 at a serve path's shape: CUDA-event times of the kernel wrapper,
    its plain version and matmul·scale + noise, masked, argmax."""
    V, v_real, d, _, scale = head
    y, table, noise = k6_inputs(B, gen, True, head)
    pad = torch.arange(V, device=DEV) >= v_real

    def library():
        lg = torch.matmul(y, table.T) * scale + noise
        return lg.masked_fill_(pad, float("-inf")).argmax(dim=1)

    k6 = {"ms": cuda_ms(lambda: ds.decode_sample(y, table, noise,
                                                 scale=scale,
                                                 v_real=v_real), 50),
          "plain_ms": cuda_ms(lambda: ref.decode_sample_ref(
              y, table, noise, scale=scale, v_real=v_real), 5),
          "library_ms": cuda_ms(library, 50),
          "bytes": k6_bytes(B, v_real, d)}
    flops = 2 * B * v_real * d
    k6["bound_ms"] = max(k6["bytes"] / HBM_BYTES_PER_S,
                         flops / FP32_FLOP_PER_S) * 1e3
    del y, table, noise
    torch.cuda.empty_cache()
    return k6


# --------------------------------------------------------------------------- #
# K4 inputs, the kernel-vs-plain comparison and its timing
# --------------------------------------------------------------------------- #


def k4_inputs(B, S, H, Hk, D, dtype, gen):
    return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))]


def k4_plain(q, k, v, window=0, softcap=0.0):
    """K4's plain version, one batch row at a time: at the prefill's shape
    one row's (H, S, S) fp32 scores are 3.8 GB."""
    return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], window=window,
                                              softcap=softcap)
                      for b in range(q.shape[0])])


def k4_case(B, S, H, Hk, D, window, cap, dtype, gen):
    """(max abs error, its bound) of K4 against its plain version: 2e-5 of
    max|v| in fp32, 1e-2 in bf16 (both round the output to bf16)."""
    q, k, v = k4_inputs(B, S, H, Hk, D, dtype, gen)
    want = k4_plain(q, k, v, window, cap)
    got = fa.flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    check(got.shape == (B, S, H, D) and got.dtype == dtype,
          f"K4 output {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    bound = tol * float(v.float().abs().max())
    del q, k, v, want, got
    torch.cuda.empty_cache()
    return err, bound


def k4_work(B, S, H, Hk, D, window=0, dv=None):
    """(flops, bytes) K4 must do at a causal shape: a D-long and a
    dv-long dot (dv = D unless given: MLA's value head) per pair that the
    causal mask (and ``window``, where positive) keeps; read q, k, v once,
    write out."""
    dv = dv or D
    w = window if window and window < S else S
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    return (2 * (D + dv) * pairs,
            4 * (B * S * H * (D + dv) + B * S * Hk * (D + dv)))


def time_k4(gen, shape=K4_MAIN, window=0, dv=None):
    """K4 at a prefill's shape (with ``window`` where positive): CUDA-event
    times of the kernel wrapper, its plain version (row by row), the
    port's chunked ``models/flash.py`` forward (KV repeated to H heads
    beforehand, blocks of 1024, as the model's plain route runs it) and
    SDPA (fp32, GQA; causal, or a boolean mask of the window) with the
    backend it took, and its bound, counted on the true D (a D of 80 pads
    to the 128-wide tile) and the pairs the mask keeps. ``dv``: MLA's
    call, V zero-padded from dv to D as ``models/mla.py`` passes it to K4
    and the chunked route; SDPA gets the true dv-wide V, and the bound
    counts the true dims."""
    B, S, H, Hk, D = shape
    q, k, v = k4_inputs(B, S, H, Hk, D, torch.float32, gen)
    if dv:
        v[..., dv:] = 0.0
    out = fa.flash_attention(q, k, v, window=window)[..., :dv or D]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v[..., :dv or D]))
    i = torch.arange(S, device=DEV)
    mask = (i[None] <= i[:, None]) & (i[:, None] - i[None] < window) \
        if window else None

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    lib = sdpa().transpose(1, 2)
    err = float((lib - out).abs().max())
    check(err <= 1e-4 * float(v.abs().max()),
          f"SDPA does not compute K4's function ({err:.3e})")
    del lib, out
    torch.cuda.empty_cache()
    kern = lambda: fa.flash_attention(q, k, v, window=window)
    t = {"ms": cuda_ms(kern, 10),
         "device_ms": graph_ms(kern, calls=5, replays=4),
         "plain_ms": cuda_ms(lambda: k4_plain(q, k, v, window), 2),
         "library_ms": cuda_ms(sdpa, 5),
         "library_backend": sdpa_backend(sdpa)}
    pos = torch.arange(S, device=DEV)
    kr, vr = (torch.repeat_interleave(x, H // Hk, dim=2) for x in (k, v))
    with torch.no_grad():
        t["chunked_ms"] = cuda_ms(lambda: flash_attention_bshd(
            q, kr, vr, pos, pos, window=window or None, bq=1024, bk=1024),
            2)
    t["flops"], t["bytes"] = k4_work(B, S, H, Hk, D, window, dv)
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del q, k, v, qt, kt, vt, kr, vr, mask
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------- #
# K4's training instance and K4b (its VJP): against the plain VJP, timed
# --------------------------------------------------------------------------- #


def k4b_inputs(B, S, H, Hk, D, gen):
    """q, k, v and the cotangent dout ~ N(0, 1), fp32."""
    return [torch.randn(shape, generator=gen, device=DEV)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D),
                          (B, S, H, D))]


def k4b_smax(q, k):
    """D^-½·max‖q_r‖·max‖k_c‖: a bound of Σ_d |q'_d k_d| for any pair."""
    return q.shape[-1] ** -0.5 * float(q.norm(dim=-1).max()
                                        * k.norm(dim=-1).max())


def k4b_eps(q, k):
    """K4b's relative bound against its plain VJP, of the plain VJP on
    magnitudes, as ``tests/test_torch_cuda.py::k4b_bounds``: u·(2·D·smax
    + 4·D + 2·rep·S + 32): the scores' error, which moves p relatively; D
    products in dp and delta; up to S keys in dq and rep·S rows in dk and
    dv."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    return U * (2 * D * k4b_smax(q, k) + 4 * D + 2 * rep * S + 32)


def k4b_rows(fn, *ts, **kw):
    """``fn`` (the plain VJP) one batch row at a time, concatenated: at the
    nemotron cell's shape one row's (H, S, S) fp32 scores are 2.1 GB."""
    outs = [fn(*(t[b:b + 1] for t in ts), **kw) for b in range(ts[0].shape[0])]
    return [torch.cat(parts) for parts in zip(*outs)]


def k4b_case(B, S, H, Hk, D, window, cap, gen):
    """K4's training instance and K4b on one call: out bit for bit the
    serving instance's, lse within the plain log-sum-exp's bound, dq, dk,
    dv element by element within ``k4b_eps`` of the plain VJP on
    magnitudes (the same out and lse on both sides), a second K4b call bit
    for bit the first. Returns (max abs error, the worst ratio of an error
    to its bound, eps, max lse error over its bound)."""
    q, k, v, dout = k4b_inputs(B, S, H, Hk, D, gen)
    kw = dict(window=window, softcap=cap)
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    check(torch.equal(out, fa.flash_attention(q, k, v, **kw)),
          "K4's training instance changes out")
    want_lse = torch.cat([ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], with_lse=True, **kw)[1]
        for b in range(B)])
    eps = k4b_eps(q, k)
    lse_ratio = float((lse - want_lse).abs().max()) / (
        U * (2 * D * k4b_smax(q, k) + 2 * S + 16
             + float(want_lse.abs().max())))
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(u, w) for u, w in zip(got, again)),
          "two K4b calls on the same inputs differ")
    want = k4b_rows(ref.flash_attention_vjp_ref, q, k, v, out, lse, dout,
                    **kw)
    mags = k4b_rows(ref.flash_attention_vjp_ref, q, k, v, out, lse, dout,
                    magnitudes=True, **kw)
    err = ratio = 0.0
    for name, g, w, m, t in zip(("dq", "dk", "dv"), got, want, mags,
                                (q, k, v)):
        check(g.shape == t.shape and g.dtype == torch.float32,
              f"K4b {name} {tuple(g.shape)} {g.dtype}")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (eps * m).clamp_min(1e-30)).max()))
    del q, k, v, dout, out, lse, got, again, want, mags, want_lse
    torch.cuda.empty_cache()
    return err, ratio, eps, lse_ratio


def bwd_ms(out, inputs, dout, iters):
    """CUDA-event time of autograd's backward alone of a graph built once
    (``retain_graph``)."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                               retain_graph=True), iters)


def time_k4b(gen, shape=K4B_CELL, dense=True):
    """K4b at a training cell's attention call: CUDA-event times of the
    wrapper (3 or 4 launches) back to back and as device time (a CUDA
    graph), K4's training and serving instances (device time), the plain
    VJP (one batch row at a time), and the backward alone of the routes it
    replaced: ``models/flash.py``'s recompute backward (KV repeated, blocks
    of 1024), autograd of the dense route (``dense``: the qwen2 cell's
    parent route; at nemotron's shape its saved scores are 34 GB) and
    SDPA's fp32 backward (GQA, causal) with the backend it took; and the
    bound from ``fa.work_bwd`` at 67 TFLOP/s."""
    B, S, H, Hk, D = shape
    q, k, v, dout = k4b_inputs(B, S, H, Hk, D, gen)
    out, lse = fa.flash_attention_lse(q, k, v)
    call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)
    t = {"ms": cuda_ms(call, 10), "device_ms": graph_ms(call, calls=4,
                                                        replays=3),
         "fwd_lse_ms": graph_ms(lambda: fa.flash_attention_lse(q, k, v),
                                calls=4, replays=3),
         "fwd_ms": graph_ms(lambda: fa.flash_attention(q, k, v), calls=4,
                            replays=3),
         "plain_ms": cuda_ms(lambda: k4b_rows(
             ref.flash_attention_vjp_ref, q, k, v, out, lse, dout), 1)}
    del out, lse
    rep = H // Hk
    pos = torch.arange(S, device=DEV, dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention_bshd(leaves[0], *Lyr._repeat_kv(leaves[1], leaves[2],
                                                         rep),
                             pos, pos, bq=1024, bk=1024)
    t["chunked_bwd_ms"] = bwd_ms(o, leaves, dout, 2)
    del o
    if dense:
        o = Lyr._sdpa_dense(leaves[0], *Lyr._repeat_kv(leaves[1], leaves[2],
                                                       rep), pos, pos, 0, 0.0)
        t["dense_bwd_ms"] = bwd_ms(o, leaves, dout, 3)
        del o
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    dt = dout.transpose(1, 2)
    t["library_ms"] = bwd_ms(o, leaves, dt, 3)
    t["library_backend"] = sdpa_backend(lambda: torch.autograd.grad(
        o, leaves, dt, retain_graph=True))
    del o, qt, kt, vt, leaves, q, k, v, dout
    torch.cuda.empty_cache()
    t["flops"], t["bytes"] = fa.work_bwd(B, S, H, Hk, D)
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    t["fwd_bound_ms"] = fa.work(B, S, H, Hk, D)[0] / FP32_FLOP_PER_S * 1e3
    return t


def phase_k4b(gen):
    """K4's training instance and K4b against the plain versions at
    ``K4B_CASES`` and timed at the two cells' calls (``time_k4b``); callable
    alone: ``import chip_smoke as c; c.build_all(); c.phase_k4b(gen)``.
    Returns the largest error and error-to-bound ratio and the two shapes'
    times."""
    out = {"err": 0.0, "ratio": 0.0, "times": {}}
    for case in K4B_CASES:
        err, ratio, eps, lse_ratio = k4b_case(*case, gen)
        out["err"] = max(out["err"], err)
        out["ratio"] = max(out["ratio"], ratio)
        print(f"[chip_smoke] K4b (B, S, H, Hk, D, window, softcap) = {case}: "
              f"max abs {err:.3e}, worst error at {ratio:.2e} of its bound "
              f"(bound {eps:.2e} of the plain VJP on magnitudes); K4's "
              f"training instance gives the serving instance's out bit for "
              f"bit, lse at {lse_ratio:.2e} of its bound; a second K4b call "
              f"bitwise the first", flush=True)
        check(ratio <= 1.0 and lse_ratio <= 1.0,
              "K4b differs from its plain VJP")
    for label, key, shape in (("the qwen2 cell's", "qwen2_cell", K4B_CELL),
                              ("the nemotron cell's", "nemotron_cell",
                               K4B_NEMO)):
        t = time_k4b(gen, shape, dense=shape == K4B_CELL)
        out["times"][key] = t
        dense = f", dense autograd {t['dense_bwd_ms']:.3f} ms" \
            if "dense_bwd_ms" in t else ""
        print(f"[chip_smoke] K4b at {label} training call (B, S, H, Hk, D) "
              f"= {shape}: {t['ms']:.3f} ms/call back to back, device time "
              f"(CUDA graph) {t['device_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms (operations: {t['flops'] / 1e9:.2f} "
              f"GFLOP; bytes {t['bytes'] / 1e6:.1f} MB): "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound; "
              f"backward alone: plain VJP {t['plain_ms']:.3f} ms, chunked "
              f"models/flash.py {t['chunked_bwd_ms']:.3f} ms{dense}, SDPA "
              f"fp32 {t['library_ms']:.3f} ms ({t['library_backend']}); "
              f"K4 forward device time: training instance "
              f"{t['fwd_lse_ms']:.3f} ms, serving {t['fwd_ms']:.3f} ms, "
              f"bound {t['fwd_bound_ms']:.3f} ms "
              f"({t['fwd_bound_ms'] / t['fwd_lse_ms'] * 100:.1f} %)",
              flush=True)
    return out


# --------------------------------------------------------------------------- #
# K7 inputs, the kernel-vs-plain comparison and its timing
# --------------------------------------------------------------------------- #


def k7_inputs(B, S, H, P, N, a, shared, gen):
    """x, B, C ~ N(0, 1), dt = softplus(N(0, 1)), A = -linspace(1, 16) (the
    model's A_log range) or ``a`` on every head; ``shared``: True for one
    B/C group expanded over the heads, "B" for B alone (C per head), an int
    G for G groups as per-head copies (``ssm.broadcast_heads``)."""
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    x = f(B, S, H, P)
    dt = F.softplus(f(B, S, H))
    A = torch.full((H,), a, device=DEV) if a is not None else \
        -torch.linspace(1.0, 16.0, H, device=DEV)
    if type(shared) is int:
        return (x, dt, A, broadcast_heads(f(B, S, shared, N), H),
                broadcast_heads(f(B, S, shared, N), H))
    Bm = f(B, S, 1, N).expand(B, S, H, N) if shared else f(B, S, H, N)
    Cm = f(B, S, 1, N).expand(B, S, H, N) if shared is True \
        else f(B, S, H, N)
    return x, dt, A, Bm, Cm


def cum_max(dt, A, Q):
    """max over cells of |cumsum(dt·A)|: the largest chunk sum of |dt·A|."""
    B, S, H = dt.shape
    return float((dt * A.abs()).reshape(B, S // Q, Q, H).sum(2).max())


def k7_eps(cmax, N, Q):
    """K7's relative bound against its plain version, of the magnitude sum
    (the plain version on |x|, |B|, |C|), u = 2^-24: both sum N products for
    C·Bᵀ and up to Q for the rest, within (N + Q)·u each; their exps differ
    by <= 2 ulps; cum, an fp64 sum rounded once on both sides, differs by
    one ulp only where two fp64 sums straddle an fp32 rounding boundary,
    which moves an L by <= 4u·max|cum|."""
    return U * (4 * cmax + 2 * (N + Q) + 16)


def k7_case(B, S, H, P, N, Q, a, shared, gen):
    """K7 against its plain version element by element, and a second call
    against the first bit for bit. Returns (max abs error, the worst ratio
    of an error to its bound, eps, max|cum|, G groups)."""
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, a, shared, gen)
    want = ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Q)
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    again = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          "two K7 calls on the same inputs differ")
    groups = ssd.plan(B, S, H, P, N, Q, Bm.stride(), Cm.stride()).groups
    cmax = cum_max(dt, A, Q)
    eps = k7_eps(cmax, N, Q)
    mags = ref.ssd_intra_chunk_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), Q)
    nc = S // Q
    err = ratio = 0.0
    for g, w, m, shape in zip(got, want, mags,
                              ((B, S, H, P), (B, nc, H, N, P), (B, nc, H))):
        check(g.shape == shape and g.dtype == torch.float32,
              f"K7 output {tuple(g.shape)} {g.dtype}")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (eps * m).clamp_min(1e-30)).max()))
    del x, dt, A, Bm, Cm, want, got, again, mags
    torch.cuda.empty_cache()
    return err, ratio, eps, cmax, groups


def time_k7(gen, shape=K7_MAIN, shared=True):
    """K7 at a serve path's shape (B/C one group over the heads, as the
    model passes them, or ``shared`` as ``k7_inputs`` takes it; A as the
    model's): CUDA-event times of the kernel
    wrapper (two launches a call) back to back and as device time (a CUDA
    graph of calls), of its plain version and of the whole plain SSD
    (``models.ssm._ssd_chunked``), and its bound from ``ssd_scan.work``
    with the plan's groups. No single PyTorch call computes K7's function:
    no library time."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, None, shared, gen)
    t = {"ms": cuda_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q), 20),
         "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(x, dt, A, Bm,
                                                             Cm, Q), 3),
         "chunked_ms": cuda_ms(lambda: ssm._ssd_chunked(x, dt, A, Bm, Cm, Q,
                                                        None), 3),
         "route_ms": cuda_ms(lambda: kops.ssd(x, dt, A, Bm, Cm, chunk=Q), 5),
         "device_ms": graph_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, Bm, Cm,
                                                           Q),
                               calls=10 if B * S > 2048 else 50)}
    t["groups"] = ssd.plan(B, S, H, P, N, Q, Bm.stride(), Cm.stride()).groups
    t["flops"], t["bytes"] = ssd.work(B, S, H, P, N, Q, t["groups"])
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    return t


def k7b_inputs(B, S, H, P, N, Q, G, gen):
    """K7's inputs with B and C as (B, S, G, N) groups (A =
    -linspace(1, 16), the model's A_log range) and K7's cotangents dY, dS,
    dtot ~ N(0, 1)."""
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    ins = (f(B, S, H, P), F.softplus(f(B, S, H)),
           -torch.linspace(1.0, 16.0, H, device=DEV), f(B, S, G, N),
           f(B, S, G, N))
    nc = S // Q
    return ins, (f(B, S, H, P), f(B, nc, H, N, P), f(B, nc, H))


def k7b_heads(ins):
    """K7b's inputs as the training route passes them: one group of B/C as
    it is, G > 1 groups as per-head copies (``ssm.broadcast_heads``)."""
    x, dt, A, Bg, Cg = ins
    if Bg.shape[2] == 1:
        return ins
    H = x.shape[2]
    return x, dt, A, broadcast_heads(Bg, H), broadcast_heads(Cg, H)


def k7b_route(ins, Q, cots):
    """K7b as the training route calls it (``k7b_heads``), with the
    copies' dB and dC summed over each group's heads, as autograd of the
    copy sums them."""
    B, S, H, _ = ins[0].shape
    G, N = ins[3].shape[2], ins[3].shape[3]
    dx, ddt, dA, dB, dC = ssd.ssd_intra_chunk_bwd(*k7b_heads(ins), Q, *cots)
    if G == 1:
        return dx, ddt, dA, dB, dC
    fold = lambda t: t.reshape(B, S, G, H // G, N).sum(3)
    return dx, ddt, dA, fold(dB), fold(dC)


def k7b_eps(cmax, H, P, N, Q, G=1):
    """K7b's relative bound against its plain VJP, of the plain VJP on
    magnitudes (``magnitudes=True``), as
    ``tests/test_torch_cuda.py::k7b_bounds``: u·(4·max|cum| + 2(N + Q + P
    + H/G) + hs·P + 16), u = 2^-24. Both sides sum P products for M, N for
    G and B·dS, up to Q for Wᵀ·dY, dG·B, dGᵀ·C and R's row sums, H/G heads
    for dG (with G > 1 groups as per-head copies: the sum of the copies'
    dB and dC); the kernel sums (xdt·decay)·dSᵀ over a split's hs heads
    (one group: ``ssd.HEADS_A_SPLIT``) in one chain; the exps and cum move
    as ``k7_eps`` says."""
    hs = ssd.HEADS_A_SPLIT if G == 1 else 1
    return U * (4 * cmax + 2 * (N + Q + P + H // G) + hs * P + 16)


def k7b_case(B, S, H, P, N, Q, G, gen):
    """K7b on the training route (``k7b_route``) against the plain VJP of
    the G-group SSD (``ref.ssd_intra_chunk_vjp_ref``) element by element
    within ``k7b_eps`` of the VJP on magnitudes, and a second call against
    the first bit for bit. Returns (max abs error, the worst ratio of an
    error to its bound, eps, max|cum|)."""
    ins, cots = k7b_inputs(B, S, H, P, N, Q, G, gen)
    want = ref.ssd_intra_chunk_vjp_ref(*ins, Q, *cots)
    got = k7b_route(ins, Q, cots)
    again = k7b_route(ins, Q, cots)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          "two K7b calls on the same inputs differ")
    cmax = cum_max(ins[1], ins[2], Q)
    eps = k7b_eps(cmax, H, P, N, Q, G)
    mags = ref.ssd_intra_chunk_vjp_ref(*ins, Q, *cots, magnitudes=True)
    err = ratio = 0.0
    for name, g, w, m, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                                mags, ins):
        check(g.shape == t.shape and g.dtype == torch.float32,
              f"K7b {name} {tuple(g.shape)} {g.dtype}")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (eps * m).clamp_min(1e-30)).max()))
    del ins, cots, want, got, again, mags
    torch.cuda.empty_cache()
    return err, ratio, eps, cmax


def time_k7b(gen, shape=K7B_CELL):
    """K7b at a training route's shape (B/C in G groups, G > 1 reaching it
    as per-head copies made before the timing, ``k7b_heads``; A as the
    model's): CUDA-event times of the wrapper (four launches a call) back
    to back and as device time (a CUDA graph of calls), of the plain VJP at
    G groups, and the bound from ``ssd_scan.work_bwd`` at G groups (the
    copies' work on H groups as ``copies_bound_ms``). No library computes
    K7's VJP (the route replaced autograd of the plain SSD)."""
    B, S, H, P, N, Q, G = shape
    ins, cots = k7b_inputs(B, S, H, P, N, Q, G, gen)
    heads = k7b_heads(ins)
    call = lambda: ssd.ssd_intra_chunk_bwd(*heads, Q, *cots)
    t = {"ms": cuda_ms(call, 20),
         "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_vjp_ref(
             *ins, Q, *cots), 3),
         "device_ms": graph_ms(call, calls=10 if B * S > 2048 else 50)}
    if G > 1:
        fl, by = ssd.work_bwd(B, S, H, P, N, Q, H)
        t["copies_bound_ms"] = max(by / HBM_BYTES_PER_S,
                                   fl / FP32_FLOP_PER_S) * 1e3
    t["flops"], t["bytes"] = ssd.work_bwd(B, S, H, P, N, Q, G)
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del ins, cots, heads
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------- #
# serving phases
# --------------------------------------------------------------------------- #


def reset_counts():
    for fn in (fa.flash_attention, ds.decode_attention, ds.decode_sample,
               ssd.ssd_intra_chunk, su.fused_step_flat):
        fn.launches = 0


def read_counts():
    return {"k4": fa.flash_attention.launches,
            "k5": ds.decode_attention.launches,
            "k6": ds.decode_sample.launches,
            "k7": ssd.ssd_intra_chunk.launches}


def full_params(arch):
    """The weights ``serve`` makes for seed 0 at ``arch``'s full width."""
    cfg = get_config(arch)
    return cfg, build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0))


def serve_path(arch, kw, want, **flags):
    """``serve`` of ``arch`` at full width and depth with the kernel
    ``flags``, counts set to 0 just before and read just after; checks the
    counts against ``want`` and the ids against the real vocabulary.
    Returns (result, counts, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve_mod.serve(arch, reduced=False, device="cuda", verbose=False,
                          **flags, **kw)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = kw["gen_len"] - 1
    t = res.timings
    print(f"[chip_smoke]   TTFT (prefill, B={kw['batch']}, S="
          f"{kw['prompt_len']}) {t['prefill_s'] * 1e3:.3f} ms; decode "
          f"{steps} steps {t['decode_s']:.4f} s, median step "
          f"{float(np.median(res.per_token_s)) * 1e3:.3f} ms; "
          f"{t['tok_per_s']:.2f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    v_real = get_config(arch).vocab_size
    check(res.tokens.shape == (kw["batch"], kw["gen_len"]),
          f"{arch} tokens {res.tokens.shape}")
    check(0 <= int(res.tokens.min()) and int(res.tokens.max()) < v_real,
          f"{arch}: an id outside the real vocabulary")
    check(counts == want, f"{arch} launches {counts}, expected {want}")
    return res, counts, peak


def continuous_check(arch, params, trace, flags, solo_flags,
                     prefill_calls, k5_calls):
    """``serve_continuous`` of ``arch`` at full width with the kernel
    ``flags`` on the weights ``params``, counts set to 0 just before and
    read just after, and held: ``prefill_calls`` ({kernel: calls}) for each
    admitted request, ``k5_calls`` K5 calls and one K6 launch a decode step.
    Then three of its requests held against solo serving (``solo_flags``),
    teacher-forced on the ring's tokens under the near-tie rule (a B=1
    decode runs other cuBLAS kernels than the ring's B=8 one); each
    admission's B=1 prefill cache tree went into its slot through
    ``insert_slot``. Returns (result, counts, exceptions, ids compared)."""
    cfg = get_config(arch)
    reset_counts()
    res = serve_mod.serve_continuous(arch, reduced=False, device="cuda",
                                     verbose=False, params=params, **flags,
                                     **trace)
    counts = read_counts()
    m = res.metrics
    n = trace["n_requests"]
    print(f"[chip_smoke]   {m['n_requests']} requests / {m['slots']} slots: "
          f"{m['total_tokens']} tokens in {m['makespan_steps']} steps "
          f"({m['tok_per_step']:.3f} tokens/step), {m['decode_steps']} "
          f"decode steps, p50 step {m['p50_step_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_step_s'] * 1e3:.3f} ms, wall {m['wall_s']:.3f} s "
          f"({m['wall_tok_per_s']:.1f} tokens/s), prefill "
          f"{m['prefill_s']:.3f} s, mean queue delay "
          f"{m['mean_queue_delay_steps']:.3f} steps; launches {counts}",
          flush=True)
    check(all(rq["finish"] is not None for rq in res.requests.values()),
          f"{arch}: a request did not finish")
    _, gens = serve_mod.poisson_trace(n, trace["arrival_rate"], trace["seed"],
                                      trace["gen_len"])
    check([len(res.tokens[r]) for r in range(n)] == [int(g) for g in gens],
          f"{arch}: a request got the wrong token count")
    steps = m["decode_steps"]
    want = {"k4": 0, "k7": 0, **{k: c * n for k, c in prefill_calls.items()},
            "k5": K5_PER_CALL * k5_calls * steps, "k6": steps}
    check(counts == want, f"{arch} continuous launches {counts}, expected "
          f"{want}")
    check(all(int(t.max()) < cfg.vocab_size for t in res.tokens.values()),
          f"{arch}: an id outside the real vocabulary")
    S, G = trace["prompt_len"], trace["gen_len"]
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            **solo_flags))
    ties = compared = 0
    with torch.inference_mode():
        for r in (0, 7, 15):
            ring = torch.from_numpy(res.tokens[r]).to(DEV)
            prompt = serve_mod.request_prompt(cfg, trace["seed"], r, S, DEV)
            logits, cache = kern.prefill_cache(params, prompt, S + G)
            first = sample_ids(logits, 0.0, cfg.vocab_size)
            check(int(first[0]) == int(ring[0]),
                  f"{arch} request {r}: first token differs from solo")
            for g in range(1, len(ring)):
                lg, cache = kern.decode(params, cache, ring[g - 1:g],
                                        S + g - 1)
                want_id = sample_ids(lg, 0.0, cfg.vocab_size)
                t, bad = ref.near_tie_check(lg, ring[g:g + 1], want_id,
                                            cfg.vocab_size)
                check(bad == 0, f"{arch} request {r} step {g}: ring token "
                      f"breaks the near-tie rule against solo serving")
                ties += t
                compared += 1
    print(f"[chip_smoke]   ring tokens vs solo serving (requests 0, 7, 15, "
          f"teacher-forced): {compared} ids, near-tie exceptions {ties}",
          flush=True)
    return res, counts, ties, compared


def teacher_forced(cfg, params):
    """Kernel path against plain path at full width on one prompt: each
    step both paths get the plain path's greedy token; the kernel path's
    ids are held to the plain logits under the near-tie rule. Returns
    (exceptions, ids compared)."""
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        logits, cache_p = plain.prefill_cache(params, prompt, S + G)
        cache_k = {k: v.clone() for k, v in cache_p.items()}
        tok = sample_ids(logits, 0.0, cfg.vocab_size)
        zeros = torch.zeros_like(logits)
        head = kern.sample_head(params)
        ties = 0
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"teacher-forced step {g}: kernel ids break the "
                  f"near-tie rule")
            ties += t
            tok = want
    return ties, B * (G - 1)


def long_teacher_forced(cfg, params):
    """The K4 path (K4 prefill, K5/K6 decode) against the plain path (the
    chunked ``models/flash.py`` prefill, dense decode) at full width on the
    long prompt, teacher-forced on the plain path's greedy tokens. Held:
    last-position logits within 1e-4·max|logit|, the bf16 caches within
    2^-7·max|cache| (one bf16 ulp at the top binade), every id under the
    near-tie rule. Returns (logit error, its bound, cache error, the
    largest ratio of a layer's cache error to its bound, near-tie
    exceptions, ids compared)."""
    B, S, G = LONG["batch"], LONG["prompt_len"], LONG["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_flash_kernel=True,
                                            use_decode_kernel=True))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        lerr = float((lg_k - lg_p).abs().max())
        lbound = 1e-4 * float(lg_p.abs().max())
        check(lerr <= lbound, f"long prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cerr = cratio = 0.0
        for key in ("k", "v"):
            for i, (a, b) in enumerate(zip(cache_k[key], cache_p[key])):
                e = float((a.float() - b.float()).abs().max())
                bound = 2.0 ** -7 * float(b.float().abs().max())
                check(e <= bound, f"long prefill cache {key}, layer {i}: "
                      f"differs by {e:.3e} (bound {bound:.3e})")
                cerr, cratio = max(cerr, e), max(cratio, e / bound)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, "long prefill: K4 path's first ids break the "
              "near-tie rule")
        tok = want
        zeros = torch.zeros_like(lg_p)
        head = kern.sample_head(params)
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"long prompt, teacher-forced step {g}: K4 "
                  f"path's ids break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k
    torch.cuda.empty_cache()
    return lerr, lbound, cerr, cratio, ties, B * G


class CumRecorder:
    """While entered, wraps the K7 route's composition
    (``ssd_scan.ssd_kernel_forward``, which ``ssm.ssd_chunked`` calls on
    the card) and records the largest |cum| of every call, for the
    teacher-forced bound."""

    def __init__(self):
        self.max = 0.0

    def __enter__(self):
        self.real, ssd.ssd_kernel_forward = ssd.ssd_kernel_forward, self
        return self

    def __exit__(self, *exc):
        ssd.ssd_kernel_forward = self.real

    def __call__(self, xh, dt, A, Bm, Cm, chunk, h0=None, **kw):
        self.max = max(self.max, cum_max(dt, A, chunk))
        return self.real(xh, dt, A, Bm, Cm, chunk, h0, **kw)


@contextlib.contextmanager
def plain_ssd():
    """The model's SSD on the plain scan (``ssm._ssd_chunked``) where it
    takes K7 by default: the oracle of the K7 prefill. Checks that no K7
    launch ran inside."""
    real, ssm._takes_k7 = ssm._takes_k7, lambda xh: False
    before = ssd.ssd_intra_chunk.launches
    try:
        yield
    finally:
        ssm._takes_k7 = real
    check(ssd.ssd_intra_chunk.launches == before,
          "the plain prefill launched K7")


def mamba_teacher_forced(cfg, params):
    """The K7 route (the default K7 prefill, K6 decode) against the plain
    route (``plain_ssd`` prefill, plain decode) at full width on one prompt,
    teacher-forced on the plain route's greedy tokens. Held, with
    eps = u·(4·max|cum| + N + Q + 2·nc + 8), u = 2^-24, max|cum| recorded
    over the prefill's 48 SSD calls (both routes accumulate cum in fp64 and
    round it once, so cum differs by at most one ulp, which moves an L by
    <= 4u·max|cum|; the products add (N + Q)·u, the chunk recurrence 2u per
    chunk; the fp32 projections and norms around the SSD add ~d·u, far
    below): last-position logits within eps·max|logit|, every leaf of the
    decode cache (h, conv tails) within eps of its largest value, every id
    under the near-tie rule. Returns (logit error, its bound, the worst
    ratio of a cache leaf's error to its bound, near-tie exceptions, ids
    compared, max|cum|)."""
    B, S, G = MAMBA["batch"], MAMBA["prompt_len"], MAMBA["gen_len"]
    s = cfg.ssm
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        with plain_ssd():
            lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        with CumRecorder() as rec:
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        eps = U * (4 * rec.max + s.d_state + s.chunk + 2 * (S // s.chunk)
                   + 8)
        lerr = float((lg_k - lg_p).abs().max())
        lbound = eps * float(lg_p.abs().max())
        check(lerr <= lbound, f"mamba2 prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cratio = 0.0
        for key, want in cache_p["mamba"].items():
            e = float((cache_k["mamba"][key] - want).abs().max())
            bound = eps * float(want.abs().max())
            check(e <= bound, f"mamba2 prefill cache {key}: differs by "
                  f"{e:.3e} (bound {bound:.3e})")
            cratio = max(cratio, e / bound)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, "mamba2 prefill: K7 route's first ids break the "
              "near-tie rule")
        tok = want
        zeros = torch.zeros_like(lg_p)
        head = kern.sample_head(params)
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"mamba2 teacher-forced step {g}: K7/K6 route's "
                  f"ids break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k, head
    torch.cuda.empty_cache()
    return lerr, lbound, cratio, ties, B * G, rec.max


# --------------------------------------------------------------------------- #
# phase 10: the hybrid (zamba2-2.7b) and qwen3-4b at full width
# --------------------------------------------------------------------------- #


def prefill_profile(cfg, params, kw, **flags):
    """Device time of one kernel-route prefill at ``kw``'s shape, split by
    ``profile_serve.prefill_breakdown`` (K4, K7, GEMMs, the rest)."""
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    B, S = kw["batch"], kw["prompt_len"]
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        model.prefill_cache(params, prompt, S + kw["gen_len"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill_cache(params, prompt, S + kw["gen_len"])
            torch.cuda.synchronize()
    out = profile_serve.prefill_breakdown(prof)
    top = out["prefill_top_kernels"][:5]
    del prof
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   {cfg.name} prefill device time "
          f"{out['prefill_device_ms']:.2f} ms: K7 "
          f"{out['prefill_k7_ms']:.2f} ms ({out['prefill_k7_launches']} "
          f"launches), K4 {out['prefill_k4_ms']:.2f} ms "
          f"({out['prefill_k4_launches']}), GEMMs "
          f"{out['prefill_gemm_ms']:.2f} ms, rest "
          f"{out['prefill_other_ms']:.2f} ms; top "
          f"{[(e['name'][:40], round(e['ms'], 2)) for e in top]}",
          flush=True)
    return out


def decode_same_cache(cfg, params, cache, tok, S, G, kern, plain, what):
    """K5/K6 decode against the plain decode, each from its own clone of
    one prefill cache, teacher-forced on the plain route's greedy tokens;
    ids under the near-tie rule. Returns (exceptions, ids compared)."""
    clone = lambda c: tree_map(lambda t: t.clone(), c)
    cache_p, cache_k = clone(cache), clone(cache)
    head = kern.sample_head(params)
    ties = 0
    with torch.inference_mode():
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            zeros = torch.zeros_like(lg)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"{what} teacher-forced step {g}: K5/K6 ids "
                  f"break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k, head
    return ties, tok.shape[0] * (G - 1)


def hold_prefill(cfg, params, kw, kern_flags, cache_tol, what, rec=None):
    """The kernel-route prefill against the plain route's at full width on
    one prompt: last logits within tol·max|logit|, every fp32 cache leaf
    within tol of its largest value, every bf16 leaf within tol plus one
    bf16 ulp at the top binade (2^-7·max), the first ids under the
    near-tie rule. ``cache_tol()`` gives tol after the kernel prefill (the
    SSD's eps needs its max|cum|, recorded by ``rec``). Returns (logit
    error, its bound, worst ratio of a cache leaf's error to its bound,
    near-tie exceptions, the plain cache, the plain greedy ids)."""
    B, S, G = kw["batch"], kw["prompt_len"], kw["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            **kern_flags))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        with plain_ssd():
            lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        with rec or contextlib.nullcontext():
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        tol = cache_tol()
        lerr = float((lg_k - lg_p).abs().max())
        lbound = tol * float(lg_p.abs().max())
        check(lerr <= lbound, f"{what} prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cratio = 0.0
        for (path, a), (_, b) in zip(tree_paths(cache_k),
                                     tree_paths(cache_p)):
            for i in range(a.shape[0]):      # layer by layer
                x, y = a[i].float(), b[i].float()
                top = float(y.abs().max())
                bound = tol * top + (2.0 ** -7 * top if b.dtype ==
                                     torch.bfloat16 else 0.0)
                e = float((x - y).abs().max())
                check(e <= bound, f"{what} prefill cache {path}[{i}]: "
                      f"differs by {e:.3e} (bound {bound:.3e})")
                cratio = max(cratio, e / bound if bound else 0.0)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, f"{what} prefill: the kernel route's first ids "
              f"break the near-tie rule")
    del cache_k, lg_k
    torch.cuda.empty_cache()
    return lerr, lbound, cratio, ties, cache_p, want, plain


def zamba_phase():
    """10a: zamba2-2.7b served at full width and depth through K7, K4, K5
    and K6; its prefill's device time by kernel; the kernel prefill held
    against the plain one (``plain_ssd`` + dense attention) and the K5/K6
    decode against the plain decode, teacher-forced. 10b: continuous
    batching on 8 slots, three requests held against solo serving."""
    steps = ZAMBA["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] 10a zamba2 serve path: serve('zamba2-2.7b', "
          f"reduced=False, {flags}, {ZAMBA})", flush=True)
    res, counts, peak = serve_path(
        "zamba2-2.7b", ZAMBA,
        {"k4": N_ZAMBA_APPS, "k5": K5_PER_CALL * N_ZAMBA_APPS * steps,
         "k6": steps, "k7": N_ZAMBA_LAYERS}, **flags)
    del res
    cfg, params = full_params("zamba2-2.7b")
    prof = prefill_profile(cfg, params, ZAMBA, use_flash_kernel=True)
    check(prof["prefill_k7_launches"] == 2 * N_ZAMBA_LAYERS
          and prof["prefill_k4_launches"] == N_ZAMBA_APPS,
          f"profiled prefill launches K7 {prof['prefill_k7_launches']}, "
          f"K4 {prof['prefill_k4_launches']}")
    s = cfg.ssm
    S = ZAMBA["prompt_len"]
    rec = CumRecorder()
    # K7 as mamba_teacher_forced's eps; K4 within 2e-5·max|v| of its plain
    # version, which the shared block's MLP and later layers carry to the
    # logits: 1e-4 of their largest, as the long-prompt K4 path is held
    tol = lambda: U * (4 * rec.max + s.d_state + s.chunk + 2 * (S // s.chunk)
                       + 8) + 1e-4
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, ZAMBA, dict(use_flash_kernel=True), tol, "zamba2", rec)
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok, S,
                                     ZAMBA["gen_len"], kern, plain,
                                     "zamba2")
    del cache_p
    torch.cuda.empty_cache()
    print(f"[chip_smoke] 10a K7 + K4 prefill vs plain scan + dense prefill, "
          f"full width: last logits max abs {lerr:.3e} (bound {lbound:.3e},"
          f" max|cum| {rec.max:.1f}), cache leaves at {cratio:.3f} of their "
          f"bounds at worst, first ids near-tie exceptions {ties}; K5/K6 "
          f"decode vs plain from one cache: {n_ids} ids, near-tie "
          f"exceptions {dties}", flush=True)
    print(f"[chip_smoke] 10b serve_continuous('zamba2-2.7b', reduced=False, "
          f"{flags}, {ZTRACE})", flush=True)
    _, ccounts, _, _ = continuous_check(
        "zamba2-2.7b", params, ZTRACE, flags, flags,
        {"k7": N_ZAMBA_LAYERS, "k4": N_ZAMBA_APPS}, N_ZAMBA_APPS)
    del params, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "ccounts": ccounts, "peak": peak,
            "prefill": prof}


def qwen3_phase():
    """10c: qwen3-4b served at full width and depth through K4, K5 and K6;
    its prefill's device time by kernel; the K4 prefill held against the
    plain (dense) one, and the K5/K6 decode against the plain decode,
    teacher-forced."""
    steps = QWEN3["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] 10c qwen3 serve path: serve('qwen3-4b', "
          f"reduced=False, {flags}, {QWEN3})", flush=True)
    res, counts, peak = serve_path(
        "qwen3-4b", QWEN3,
        {"k4": N_QWEN3_LAYERS, "k5": K5_PER_CALL * N_QWEN3_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    del res
    cfg, params = full_params("qwen3-4b")
    prof = prefill_profile(cfg, params, QWEN3, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_QWEN3_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    # as the long-prompt K4 path: 1e-4 of the largest logit
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, QWEN3, dict(use_flash_kernel=True), lambda: 1e-4,
        "qwen3")
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok,
                                     QWEN3["prompt_len"], QWEN3["gen_len"],
                                     kern, plain, "qwen3")
    print(f"[chip_smoke] 10c K4 prefill vs dense prefill, full width: last "
          f"logits max abs {lerr:.3e} (bound {lbound:.3e}), cache leaves at "
          f"{cratio:.3f} of their bounds at worst, first ids near-tie "
          f"exceptions {ties}; K5/K6 decode vs plain from one cache: "
          f"{n_ids} ids, near-tie exceptions {dties}", flush=True)
    del params, cache_p, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "peak": peak, "prefill": prof}


def register_cut(arch, layers):
    """``arch`` at full width cut to ``layers`` layers, registered so that
    ``train.main`` drives it; returns its id (``arch`` itself when
    ``layers`` is None)."""
    if layers is None:
        return arch
    name = f"{arch}-{layers}l"
    mod = types.ModuleType("repro_torch.configs." + name.replace("-", "_")
                           .replace(".", "p"))
    mod.CONFIG = mod.REDUCED = get_config(arch).replace(n_layers=layers)
    sys.modules[mod.__name__] = mod
    configs.register(name, mod.__name__.rsplit(".", 1)[1])
    return name


def tree_n(cfg):
    """The per-client flat length n of ``cfg``'s parameter tree (no
    storage)."""
    with FakeTensorMode():
        return tree_size(build_model(cfg).init(torch.Generator()))


def zamba_train_phase():
    """10d: savic on full-width zamba2-2.7b cut to 12 layers (two
    applications of the shared block), M = 4, H = 2, b = 8, S = 128, 2
    rounds through ``train.main`` on the fused loop (K1 once a local step),
    its SSD on the card's training route (K7 + K7b: K7 twice a K7b, for
    the remat recompute) and attention on the plain route; then fused
    against tree at 6 layers (one application)."""
    register_cut("zamba2-2.7b", 12)
    argv = ["--arch", ARCH_Z12, "--method", "savic", "--use-fused-kernel",
            "--rounds", "2", "--h-local", str(H_LOCAL), "--clients", "4",
            "--batch", "8", "--seq", "128", "--device", "cuda"]
    cfg = get_config(ARCH_Z12)
    n = tree_n(cfg)
    print(f"[chip_smoke] 10d zamba2 training, full width, 12 layers (n = "
          f"{n} in the tree; param_count() {cfg.param_count()}): "
          f"train.main " + " ".join(argv), flush=True)
    log, k1, _, peak = main_path(argv, 2 * H_LOCAL,
                                 expect_k4b=k4b_calls(ARCH_Z12, 4, 2))
    k7, k7b = ssd.ssd_intra_chunk.launches, ssd.ssd_intra_chunk_bwd.launches
    k4, k4b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    check(k7b > 0 and k7 == 2 * k7b, f"10d: K7 {k7}, K7b {k7b} launched")
    check(all(finite(rec["loss"]) for rec in log), "zamba2 loss not finite")
    worst, _, k1_6 = fused_vs_tree(
        "zamba2 savic", cfg=get_config("zamba2-2.7b").replace(n_layers=6))
    return {"k1": k1, "k7": k7, "k7b": k7b, "k4": k4, "k4b": k4b, "n": n,
            "peak": peak, "walls": [r["wall_s"] for r in log],
            "tokens_per_s": [r["tokens_per_s"] for r in log],
            "fused_vs_tree": worst, "k1_6": k1_6}


def new_shape_kernels(gen):
    """K4, K5, K6 and K7 held against their plain versions at the shapes
    zamba2's and qwen3's serves give them, and timed there. Returns the
    per-kernel errors and timing dicts."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0, "k7_err": 0.0}
    for shape in (K4_ZAMBA, K4_QWEN3, (1, 256, 32, 32, 80),
                  (1, 1000, 32, 32, 80)):
        err, bound = k4_case(*shape, 0, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={shape}: max abs {err:.3e} "
              f"(bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at {shape}")
    for B_, C_, Hk_, rep_, D_ in (K5_ZAMBA, K5_QWEN3, (8, 320, 32, 1, 80),
                                  (1, 4099, 32, 1, 80)):
        for cap in (0.0, 30.0):
            err, bound = k5_case(B_, C_, Hk_, rep_, D_, cap, gen)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B={B_} C={C_} Hk={Hk_} rep={rep_} "
                  f"D={D_} softcap={cap} plan "
                  f"{ds.attention_plan(B_, Hk_, C_)}: max abs {err:.3e} "
                  f"(bound {bound:.1e})", flush=True)
            check(err <= bound, "K5 differs from its plain version")
    for name, B_ in (("zamba2-2.7b", ZAMBA["batch"]),
                     ("zamba2-2.7b", ZTRACE["slots"]),
                     ("qwen3-4b", QWEN3["batch"])):
        for greedy in (True, False):
            ties, bad, err = k6_case(B_, greedy, gen, head=WIDE_HEADS[name])
            out["k6_err"] = max(out["k6_err"], err)
            print(f"[chip_smoke] K6 {name} head B={B_} "
                  f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions"
                  f" {ties}, violations {bad}, winning logit max abs "
                  f"{err:.3e}", flush=True)
            check(bad == 0, f"K6 breaks the near-tie rule at {name}'s head")
    for shape, a in ((K7_ZAMBA, None), (K7_ZAMBA_ONE, None),
                     (K7_ZAMBA_ONE, -16.0)):
        err, ratio, eps, cmax, groups = k7_case(*shape, a, True, gen)
        out["k7_err"] = max(out["k7_err"], err)
        print(f"[chip_smoke] K7 B,S,H,P,N,Q={shape} A="
              f"{'-linspace(1, 16)' if a is None else a} B/C head stride 0 "
              f"({groups} G group): max abs {err:.3e}, worst error at "
              f"{ratio:.3f} of its bound (eps {eps:.2e}, max|cum| "
              f"{cmax:.1f})", flush=True)
        check(ratio <= 1.0, f"K7 differs from its plain version at {shape}")
    out["k4"] = {"zamba2": time_k4(gen, K4_ZAMBA),
                 "qwen3": time_k4(gen, K4_QWEN3)}
    out["k5"] = {"zamba2": time_k5(K5_ZAMBA, gen),
                 "qwen3": time_k5(K5_QWEN3, gen)}
    out["k6"] = {name: time_k6(gen, B_, WIDE_HEADS[name]) for name, B_ in
                 (("zamba2-2.7b", ZAMBA["batch"]),
                  ("qwen3-4b", QWEN3["batch"]))}
    out["k7"] = {"zamba2": time_k7(gen, K7_ZAMBA),
                 "zamba2_one": time_k7(gen, K7_ZAMBA_ONE)}
    for key, t in out["k4"].items():
        print(f"[chip_smoke] K4 at {key}'s prefill shape "
              f"{K4_ZAMBA if key == 'zamba2' else K4_QWEN3}: "
              f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), "
              f"plain {t['plain_ms']:.3f} ms, chunked "
              f"{t['chunked_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms (operations on the true D: "
              f"{t['flops'] / 1e9:.2f} GFLOP), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s", flush=True)
    for key, t in out["k5"].items():
        print(f"[chip_smoke] K5 at {key}'s decode shape "
              f"{K5_ZAMBA if key == 'zamba2' else K5_QWEN3}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back, device "
              f"{t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us (device "
              f"{t['plain_device_ms'] * 1e3:.2f}), SDPA "
              f"{t['library_ms'] * 1e3:.2f} us (device "
              f"{t['library_device_ms'] * 1e3:.2f}), bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
              f"{t['plan']}", flush=True)
    for key, t in out["k6"].items():
        print(f"[chip_smoke] K6 at {key}'s head: {t['ms'] * 1e3:.2f} "
              f"us/call, plain {t['plain_ms'] * 1e3:.2f} us, matmul + argmax "
              f"{t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    for key, t in out["k7"].items():
        print(f"[chip_smoke] K7 at {key} "
              f"{K7_ZAMBA if key == 'zamba2' else K7_ZAMBA_ONE}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back, device "
              f"{t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, whole _ssd_chunked "
              f"{t['chunked_ms'] * 1e3:.2f} us, K7 route "
              f"{t['route_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['flops'] / 1e9:.3f} GFLOP), "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound on "
              f"device time", flush=True)
    return out


def phase10(gen):
    """Phase 10 in the order 10a-10d, then the kernels at the new shapes;
    returns what the kernels line and the summary need."""
    t0 = time.perf_counter()
    z = zamba_phase()
    q = qwen3_phase()
    tr = zamba_train_phase()
    ks = new_shape_kernels(gen)
    print(f"[chip_smoke] phase 10: {time.perf_counter() - t0:.1f} s; peaks "
          f"zamba2 serve {z['peak']:.2f} GiB, qwen3 serve {q['peak']:.2f} "
          f"GiB, zamba2 12-layer savic {tr['peak']:.2f} GiB (K1 "
          f"{tr['k1']}, rounds {tr['walls']} s, {tr['tokens_per_s']} "
          f"tokens/s; fused vs tree at 6 layers {tr['fused_vs_tree']:.3e}, "
          f"K1 {tr['k1_6']})", flush=True)
    return {"zamba": z, "qwen3": q, "train": tr, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 11: gemma3-4b at full width and depth
# --------------------------------------------------------------------------- #


def gemma3_phase():
    """11a: gemma3-4b served at full width and depth through K4 (each of its
    34 layers: 29 with the 1024 window, 5 global), K5 (the window in each
    local layer's bias) and K6 (on the tied table itself); its prefill's
    device time by kernel. 11b: the K4 prefill held against the plain one
    (the chunked ``models/flash.py`` with the same per-layer windows) and
    the K5/K6 decode against the plain decode, teacher-forced from one
    cache."""
    cfg = get_config("gemma3-4b")
    wins = transformer.layer_windows(cfg, cfg.n_layers)
    check(cfg.n_layers == N_GEMMA_LAYERS and cfg.head_dim == K4_GEMMA[4]
          and tuple(i for i, w in enumerate(wins) if w != GEMMA_WINDOW)
          == GEMMA_GLOBAL, f"gemma3-4b's windows {wins}")
    steps = GEMMA["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] 11a gemma3 serve path: serve('gemma3-4b', "
          f"reduced=False, {flags}, {GEMMA}); global layers {GEMMA_GLOBAL}, "
          f"the other {N_GEMMA_LAYERS - len(GEMMA_GLOBAL)} at window "
          f"{GEMMA_WINDOW}", flush=True)
    res, counts, peak = serve_path(
        "gemma3-4b", GEMMA,
        {"k4": N_GEMMA_LAYERS, "k5": K5_PER_CALL * N_GEMMA_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    del res
    cfg, params = full_params("gemma3-4b")
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    check(kern.sample_head(params)[0].data_ptr()
          == params["embed"]["table"].data_ptr(),
          "K6's head is a copy of gemma3's tied table")
    prof = prefill_profile(cfg, params, GEMMA, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_GEMMA_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    # as the long-prompt K4 path: 1e-4 of the largest logit
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, GEMMA, dict(use_flash_kernel=True), lambda: 1e-4,
        "gemma3")
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok,
                                     GEMMA["prompt_len"], GEMMA["gen_len"],
                                     kern, plain, "gemma3")
    print(f"[chip_smoke] 11b K4 prefill (per-layer windows) vs chunked "
          f"plain prefill, full width: last logits max abs {lerr:.3e} "
          f"(bound {lbound:.3e}), cache leaves at {cratio:.3f} of their "
          f"bounds at worst, first ids near-tie exceptions {ties}; K5/K6 "
          f"decode vs plain from one cache: {n_ids} ids, near-tie "
          f"exceptions {dties}", flush=True)
    del params, cache_p, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "peak": peak, "prefill": prof,
            "step_ms": step_ms, "ttft_ms": ttft_ms, "lerr": lerr,
            "lbound": lbound, "ties": ties, "dties": dties}


def gemma3_kernels(gen):
    """11c: K4 at gemma3's prefill shape, global and at its window, K5 at
    its decode shape (causal, and with the window in the bias) and K6 at
    its head, held against their plain versions and timed, SDPA beside K4
    and K5 with the backend it took."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0}
    for win in (0, GEMMA_WINDOW):
        err, bound = k4_case(*K4_GEMMA, win, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={K4_GEMMA} window={win}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at "
              f"{K4_GEMMA}, window {win}")
    for win in (0, GEMMA_WINDOW):
        for cap in (0.0, 30.0):
            err, bound = k5_case(*K5_GEMMA, cap, gen, window=win)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B,C,Hk,rep,D={K5_GEMMA} window={win} "
                  f"softcap={cap} plan "
                  f"{ds.attention_plan(K5_GEMMA[0], K5_GEMMA[2], K5_GEMMA[1])}"
                  f": max abs {err:.3e} (bound {bound:.1e})", flush=True)
            check(err <= bound, "K5 differs from its plain version at "
                  f"{K5_GEMMA}")
    head = WIDE_HEADS["gemma3-4b"]
    for greedy in (True, False):
        ties, bad, err = k6_case(GEMMA["batch"], greedy, gen, head=head)
        out["k6_err"] = max(out["k6_err"], err)
        print(f"[chip_smoke] K6 gemma3-4b head B={GEMMA['batch']} "
              f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
              f"{ties}, violations {bad}, winning logit max abs {err:.3e}",
              flush=True)
        check(bad == 0, "K6 breaks the near-tie rule at gemma3's head")
    out["k4"] = {"global": time_k4(gen, K4_GEMMA),
                 "window": time_k4(gen, K4_GEMMA, GEMMA_WINDOW)}
    out["k5"] = time_k5(K5_GEMMA, gen)
    out["k6"] = time_k6(gen, GEMMA["batch"], head)
    for key, t in out["k4"].items():
        print(f"[chip_smoke] K4 at gemma3's prefill shape {K4_GEMMA} {key}: "
              f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), "
              f"plain {t['plain_ms']:.3f} ms, chunked "
              f"{t['chunked_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms "
              f"({t['library_backend']}), bound {t['bound_ms']:.3f} ms "
              f"({t['flops'] / 1e9:.2f} GFLOP), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s, "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound "
              f"on device time", flush=True)
    t = out["k5"]
    print(f"[chip_smoke] K5 at gemma3's decode shape {K5_GEMMA}: "
          f"{t['ms'] * 1e3:.2f} us/call back to back, device "
          f"{t['device_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
          f"us (device {t['plain_device_ms'] * 1e3:.2f}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{t['library_device_ms'] * 1e3:.2f}; {t['library_backend']}), "
          f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
          f"{t['plan']}", flush=True)
    t = out["k6"]
    print(f"[chip_smoke] K6 at gemma3's head (B={GEMMA['batch']}): "
          f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"matmul + argmax {t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    return out


def phase11(gen):
    """Phase 11: 11a-11b, then the kernels at gemma3's shapes (11c)."""
    t0 = time.perf_counter()
    g = gemma3_phase()
    ks = gemma3_kernels(gen)
    n_glob = len(GEMMA_GLOBAL)
    bound = (n_glob * ks["k4"]["global"]["bound_ms"]
             + (N_GEMMA_LAYERS - n_glob) * ks["k4"]["window"]["bound_ms"])
    print(f"[chip_smoke] phase 11: {time.perf_counter() - t0:.1f} s; gemma3 "
          f"serve peak {g['peak']:.2f} GiB, TTFT {g['ttft_ms']:.1f} ms, "
          f"median step {g['step_ms']:.2f} ms; the prefill's K4 "
          f"{g['prefill']['prefill_k4_ms']:.2f} ms against a bound of "
          f"{bound:.2f} ms", flush=True)
    return {"gemma3": g, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 12: qwen2-moe-a2.7b at full width and depth
# --------------------------------------------------------------------------- #


def moe_layer_hold(cfg, params, prompt, plain_c=None):
    """12b and 13b, layer by layer: the plain route's input to each layer
    (a dense prefix block's too) goes through the block on both routes
    (``plain_c``: dense attention unless given; K4).
    K4's output is held against its plain version (``k4_plain``) on the
    very q, k and v it got, within 2e-5·max|v| (``k4_case``'s bound); the
    two routings are held under the near-tie rule, layer by layer (each
    layer's first differences against the probability differences of the
    tokens that agreed). Returns (worst K4 error / bound, routing
    differences, their worst margin / bound, the largest router
    probability difference, the largest block-output difference on tokens
    whose routing agreed)."""
    f32 = torch.float32
    tokens = prompt["tokens"]
    S = tokens.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=DEV)
    plain_c = plain_c or Lyr.AttnCall()
    k4_c = Lyr.AttnCall(use_flash_kernel=True)
    K = cfg.moe.top_k
    real_fa, seen = kops.flash_attention, []

    def spy(q, k, v, **kw):
        out = real_fa(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    k4_ratio = worst = eps = xerr = 0.0
    flips = 0
    with torch.inference_mode():
        x = Lyr.embed(params["embed"], tokens, f32)
        n_prefix = transformer._n_prefix(cfg)
        layers = list(params["blocks"].get("prefix", [])) + \
            transformer._layers(params["blocks"]["stack"],
                                cfg.n_layers - n_prefix)
        for i, bp in enumerate(layers):
            with RouteRecorder(moe_mod) as rp:
                xp, _, _ = transformer._attn_block(bp, cfg, x, pos,
                                                   transformer.HUGE_WINDOW,
                                                   plain_c, f32)
            kops.flash_attention = spy
            try:
                with RouteRecorder(moe_mod) as rk:
                    xk, _, _ = transformer._attn_block(
                        bp, cfg, x, pos, transformer.HUGE_WINDOW, k4_c, f32)
            finally:
                kops.flash_attention = real_fa
            q, k, v, kw, out = seen.pop()
            check(not kw.get("window") and not seen,
                  f"moe layer {i}: K4 called with {kw}")
            err = float((out - k4_plain(q, k, v)).abs().max())
            bound = 2e-5 * float(v.abs().max())
            check(err <= bound, f"moe layer {i}: K4 differs from its plain "
                  f"version by {err:.3e} (bound {bound:.3e})")
            k4_ratio = max(k4_ratio, err / bound)
            del q, k, v, out
            try:
                r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR)
            except AssertionError as e:
                raise RuntimeError(f"chip_smoke: moe layer {i}: {e}")
            flips += r["flips"]
            worst = max(worst, r["worst"])
            eps = max([eps] + r["eps"])         # no call in a prefix layer
            same = ~torch.zeros(xp.shape[:2], dtype=torch.bool, device=DEV)
            if r["flips"]:
                pk = torch.sort(rk.calls[0]["eidx"], -1).values
                pp = torch.sort(rp.calls[0]["eidx"], -1).values
                same = ~(pk != pp).any(-1)
            xerr = max(xerr, float((xk - xp).abs()[same].max()))
            x = xp
            del xk, rp, rk
    torch.cuda.empty_cache()
    return k4_ratio, flips, worst, eps, xerr


def moe_prefill_hold(cfg, params, prompt, S, G, plain, kern):
    """12b, end to end: the K4 prefill against the plain (dense) one on the
    same prompt, every layer's routing recorded on both. Every token's
    first routing difference is held as a near tie; a batch row in which
    no token's routing differed is held as ``hold_prefill`` holds one (last
    logits within 1e-4·max|logit|, first ids under the near-tie rule); the
    bf16 cache (K/V, or MLA's latent) of layer l is held (1e-4 of its
    largest value plus one bf16 ulp at the top binade) on the rows whose
    routing agreed in every layer before l (a dense prefix layer's on
    every row). Returns a dict of what it found, the plain cache and the
    plain greedy ids."""
    K = cfg.moe.top_k
    with torch.inference_mode():
        with RouteRecorder(moe_mod) as rp:
            lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        with RouteRecorder(moe_mod) as rk:
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        try:
            r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR)
        except AssertionError as e:
            raise RuntimeError(f"chip_smoke: moe prefill routing: {e}")
        B = lg_p.shape[0]
        clean = [b for b in range(B) if b not in r["rows"]]
        lerr = (lg_k - lg_p).abs().amax(-1)
        lbound = 1e-4 * float(lg_p.abs().max())
        for b in clean:
            check(float(lerr[b]) <= lbound, f"moe prefill row {b}: logits "
                  f"differ by {float(lerr[b]):.3e} (bound {lbound:.3e})")
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        got = sample_ids(lg_k, 0.0, cfg.vocab_size)
        ties = 0
        if clean:
            ties, bad = ref.near_tie_check(lg_p[clean], got[clean],
                                           want[clean], cfg.vocab_size)
            check(bad == 0, "moe prefill: the K4 route's first ids break "
                  "the near-tie rule")
        before = torch.zeros(B, dtype=torch.bool, device=DEV)
        cratio, held = 0.0, 0
        keys, pkeys = transformer._cache_keys(cfg)
        n_prefix = transformer._n_prefix(cfg)
        layers = [(pkeys, i, False) for i in range(n_prefix)] + \
            [(keys, i, True) for i in range(cfg.n_layers - n_prefix)]
        for names, i, routed in layers:
            rows = ~before
            for key in names:
                a = cache_k[key][i][rows].float()
                b = cache_p[key][i][rows].float()
                if not a.numel():
                    continue
                top = float(b.abs().max())
                bound = 1e-4 * top + 2.0 ** -7 * top
                e = float((a - b).abs().max())
                check(e <= bound, f"moe prefill cache {key}[{i}]: differs "
                      f"by {e:.3e} (bound {bound:.3e})")
                cratio = max(cratio, e / bound)
            held += int(rows.sum())
            if routed:
                before |= r["layer_rows"][i]
        # per MoE layer, the share of routed choices dropped by capacity
        drops = [float(1.0 - c["keep"].float().mean()) for c in rk.calls]
    out = {"routing": r, "clean": clean, "lerr": [float(e) for e in lerr],
           "lbound": lbound, "ties": ties, "cratio": cratio,
           "cache_rows_held": held, "drops": drops,
           "ids_equal": int((got == want).sum())}
    del cache_k, lg_k, rp, rk
    torch.cuda.empty_cache()
    return out, cache_p, want


def moe_decode_hold(cfg, params, cache, tok, S, G, kern, plain):
    """12b, decode: K5/K6 against the plain decode, each from its own clone
    of one prefill cache, teacher-forced on the plain route's greedy
    tokens, every step's routing recorded on both. A row whose routing
    differed in a step (a near tie, held as such) parts there and is
    compared no further; the other rows' ids are held under the near-tie
    rule. Returns (near-tie exceptions, ids compared, routing differences,
    {row: step it parted})."""
    K = cfg.moe.top_k
    clone = lambda c: tree_map(lambda t: t.clone(), c)
    cache_p, cache_k = clone(cache), clone(cache)
    head = kern.sample_head(params)
    live = torch.ones(tok.shape[0], dtype=torch.bool, device=DEV)
    ties = compared = flips = 0
    parted = {}
    with torch.inference_mode():
        for g in range(G - 1):
            with RouteRecorder(moe_mod) as rp:
                lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            zeros = torch.zeros_like(lg)
            with RouteRecorder(moe_mod) as rk:
                ids, cache_k = kern.decode_sample(params, cache_k, tok,
                                                  S + g, zeros, head)
            try:
                r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR,
                                 live=live)
            except AssertionError as e:
                raise RuntimeError(f"chip_smoke: moe decode step {g}: {e}")
            flips += r["flips"]
            for b in r["rows"]:
                parted[b] = g
                live[b] = False
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            rows = torch.nonzero(live).flatten()
            if rows.numel():
                t, bad = ref.near_tie_check(lg[rows], ids[rows], want[rows],
                                            cfg.vocab_size)
                check(bad == 0, f"moe teacher-forced step {g}: K5/K6 ids "
                      f"break the near-tie rule")
                ties += t
                compared += int(rows.numel())
            tok = want
    del cache_p, cache_k, head
    return ties, compared, flips, parted


def moe_phase():
    """12a: qwen2-moe-a2.7b served at full width and depth through K4, K5
    and K6; its prefill's device time by kernel (the routing's sort,
    scatter and gather kernels listed). 12b: the K4 prefill held layer by
    layer and end to end, the K5/K6 decode teacher-forced, every routing
    difference a near tie. 12c: continuous batching on 8 slots, three
    requests held against solo serving."""
    check(torch.cuda.memory_allocated() < 2 ** 30, "phase 12 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    cfg = get_config(MOE_ARCH)
    check(cfg.n_layers == N_MOE_LAYERS
          and cfg.param_count() == 14_315_587_584
          and moe_mod._capacity(MOE["prompt_len"], cfg.moe) == 176,
          f"{MOE_ARCH}'s config")
    steps = MOE["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print(f"[chip_smoke] 12a qwen2-moe serve path: serve('{MOE_ARCH}', "
          f"reduced=False, {flags}, {MOE}); {cfg.param_count()} parameters "
          f"({cfg.active_param_count()} active a token), capacity "
          f"{moe_mod._capacity(MOE['prompt_len'], cfg.moe)} a row in the "
          f"prefill", flush=True)
    res, counts, peak = serve_path(
        MOE_ARCH, MOE,
        {"k4": N_MOE_LAYERS, "k5": K5_PER_CALL * N_MOE_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    tok_s = res.timings["tok_per_s"]
    del res
    cfg, params = full_params(MOE_ARCH)
    prof = prefill_profile(cfg, params, MOE, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_MOE_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    disp = prof["prefill_dispatch_kernels"]
    share = prof["prefill_dispatch_ms"] / prof["prefill_device_ms"] * 100
    print(f"[chip_smoke]   routing's sort / scatter / gather / index "
          f"kernels: {prof['prefill_dispatch_ms']:.2f} ms ({share:.1f} % of "
          f"the prefill): "
          f"{[(e['name'][:40], round(e['ms'], 2)) for e in disp[:6]]}",
          flush=True)
    B, S, G = MOE["batch"], MOE["prompt_len"], MOE["gen_len"]
    prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
    k4r, lflips, lworst, leps, xerr = moe_layer_hold(cfg, params, prompt)
    print(f"[chip_smoke] 12b K4 layer by layer (the plain route's input to "
          f"each of {N_MOE_LAYERS} layers): K4 at {k4r:.3f} of its bound at "
          f"worst; routing differences {lflips} (worst margin at "
          f"{lworst:.3f} of {MOE_FLIP_FACTOR}·eps), router probabilities "
          f"within {leps:.3e}, block outputs within {xerr:.3e} where the "
          f"routing agreed", flush=True)
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    e2e, cache_p, tok = moe_prefill_hold(cfg, params, prompt, S, G, plain,
                                         kern)
    r, d = e2e["routing"], e2e["drops"]
    print(f"[chip_smoke] 12b K4 prefill vs dense prefill end to end: "
          f"routing differences {r['flips']} token-layers ({r['first']} "
          f"first differences, margins {[f'{m:.2e}' for m in r['margins']]},"
          f" worst at {r['worst']:.3f} of {MOE_FLIP_FACTOR}·eps, eps "
          f"{min(r['eps']):.2e}..{max(r['eps']):.2e} over the layers; "
          f"{r['keep_diff']} keep flags moved), rows with a difference "
          f"{r['rows']}; last logits max abs by row "
          f"{[f'{e:.3e}' for e in e2e['lerr']]} (bound {e2e['lbound']:.3e} "
          f"held on rows {e2e['clean']}), first ids equal "
          f"{e2e['ids_equal']}/{B}, near-tie exceptions {e2e['ties']}; "
          f"cache layers at {e2e['cratio']:.3f} of their bounds "
          f"({e2e['cache_rows_held']} layer-rows held)", flush=True)
    print(f"[chip_smoke] 12a routed choices dropped by capacity (C = 176, "
          f"the serve's prompt and weights, K4 route) per layer: min "
          f"{min(d) * 100:.2f} %, median {float(np.median(d)) * 100:.2f} %, "
          f"max {max(d) * 100:.2f} %", flush=True)
    dkern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                             use_decode_kernel=True))
    dties, n_ids, dflips, parted = moe_decode_hold(cfg, params, cache_p,
                                                   tok, S, G, dkern, plain)
    del cache_p
    torch.cuda.empty_cache()
    print(f"[chip_smoke] 12b K5/K6 decode vs plain from one cache, "
          f"teacher-forced: {n_ids} ids, near-tie exceptions {dties}; "
          f"routing differences {dflips} (rows parted at a near tie: "
          f"{parted})", flush=True)
    print(f"[chip_smoke] 12c serve_continuous('{MOE_ARCH}', reduced=False, "
          f"{flags}, {MOE_TRACE})", flush=True)
    cres, ccounts, _, _ = continuous_check(
        MOE_ARCH, params, MOE_TRACE, flags, flags, {"k4": N_MOE_LAYERS},
        N_MOE_LAYERS)
    cm = cres.metrics
    del params, kern, dkern, plain, cres
    torch.cuda.empty_cache()
    return {"counts": counts, "ccounts": ccounts, "peak": peak,
            "prefill": prof, "step_ms": step_ms, "ttft_ms": ttft_ms,
            "tok_s": tok_s, "e2e_flips": r["flips"], "drops": d,
            "layer_flips": lflips, "decode_flips": dflips,
            "ring_p50_ms": cm["p50_step_s"] * 1e3}


def moe_kernels(gen):
    """12d: K4, K5 and K6 held against their plain versions at the shapes
    qwen2-moe's serve and ring give them, and timed at the serve's, SDPA
    and matmul + argmax beside them, with the SDPA backend."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0}
    for shape in (K4_MOE, (1, 256, 16, 16, 128)):
        err, bound = k4_case(*shape, 0, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={shape}: max abs {err:.3e} "
              f"(bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at {shape}")
    for shape in (K5_MOE, K5_MOE_RING):
        for cap in (0.0, 30.0):
            err, bound = k5_case(*shape, cap, gen)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B,C,Hk,rep,D={shape} softcap={cap} plan "
                  f"{ds.attention_plan(shape[0], shape[2], shape[1])}: max "
                  f"abs {err:.3e} (bound {bound:.1e})", flush=True)
            check(err <= bound, f"K5 differs from its plain version at "
                  f"{shape}")
    for B_ in (MOE["batch"], MOE_TRACE["slots"]):
        for greedy in (True, False):
            ties, bad, err = k6_case(B_, greedy, gen, head=MOE_HEAD)
            out["k6_err"] = max(out["k6_err"], err)
            print(f"[chip_smoke] K6 qwen2-moe head B={B_} "
                  f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
                  f"{ties}, violations {bad}, winning logit max abs "
                  f"{err:.3e}", flush=True)
            check(bad == 0, "K6 breaks the near-tie rule at qwen2-moe's head")
    out["k4"] = time_k4(gen, K4_MOE)
    out["k5"] = time_k5(K5_MOE, gen)
    out["k6"] = time_k6(gen, MOE["batch"], MOE_HEAD)
    t = out["k4"]
    print(f"[chip_smoke] K4 at qwen2-moe's prefill shape {K4_MOE}: "
          f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), plain "
          f"{t['plain_ms']:.3f} ms, chunked {t['chunked_ms']:.3f} ms, SDPA "
          f"{t['library_ms']:.3f} ms ({t['library_backend']}), bound "
          f"{t['bound_ms']:.3f} ms ({t['flops'] / 1e9:.2f} GFLOP), "
          f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound on "
          f"device time", flush=True)
    t = out["k5"]
    print(f"[chip_smoke] K5 at qwen2-moe's decode shape {K5_MOE}: "
          f"{t['ms'] * 1e3:.2f} us/call back to back, device "
          f"{t['device_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
          f"us (device {t['plain_device_ms'] * 1e3:.2f}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{t['library_device_ms'] * 1e3:.2f}; {t['library_backend']}), "
          f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
          f"{t['plan']}", flush=True)
    t = out["k6"]
    print(f"[chip_smoke] K6 at qwen2-moe's head (B={MOE['batch']}): "
          f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"matmul + argmax {t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    return out


def phase12(gen):
    """Phase 12: 12a-12c, then the kernels at qwen2-moe's shapes (12d)."""
    t0 = time.perf_counter()
    m = moe_phase()
    ks = moe_kernels(gen)
    p = m["prefill"]
    print(f"[chip_smoke] phase 12: {time.perf_counter() - t0:.1f} s; "
          f"qwen2-moe serve peak {m['peak']:.2f} GiB, TTFT "
          f"{m['ttft_ms']:.1f} ms, median step {m['step_ms']:.2f} ms "
          f"({m['tok_s']:.2f} tokens/s), ring p50 step "
          f"{m['ring_p50_ms']:.2f} ms; the prefill's device time "
          f"{p['prefill_device_ms']:.1f} ms (K4 {p['prefill_k4_ms']:.2f} ms "
          f"against a bound of {N_MOE_LAYERS * ks['k4']['bound_ms']:.2f} ms, "
          f"GEMMs {p['prefill_gemm_ms']:.1f}, rest "
          f"{p['prefill_other_ms']:.1f})", flush=True)
    return {"moe": m, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 13: MLA (deepseek-v2-236b, 4 of 60 layers), musicgen-large and
# internvl2-1b
# --------------------------------------------------------------------------- #


def register_dsv2():
    """Full-width deepseek-v2-236b cut to 4 layers, registered as
    ``DSV2_ARCH`` so that ``serve`` drives it."""
    mod = types.ModuleType("repro_torch.configs.deepseek_v2_236b_4l")
    mod.CONFIG = mod.REDUCED = get_config("deepseek-v2-236b").replace(
        n_layers=N_DSV2_LAYERS)
    sys.modules[mod.__name__] = mod
    configs.register(DSV2_ARCH, "deepseek_v2_236b_4l")


def decode_profile(cfg, params, kw, untraced=6, traced=4, **flags):
    """A decode step at ``kw``'s batch after its prompt, with the kernel
    ``flags``: ``untraced`` greedy steps timed between synchronizations
    (the host's clock), then ``traced`` under the profiler. Returns the
    median host ms (the first step left out), the device ms a step, K6's
    ms a step and the top kernels."""
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    B, S = kw["batch"], kw["prompt_len"]
    steps = untraced + traced
    host = []
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        logits, cache = model.prefill_cache(params, prompt, S + steps + 1)
        head = model.sample_head(params) if model.call.use_decode_kernel \
            else None
        noise = torch.zeros_like(logits)
        tok = sample_ids(logits, noise, cfg.vocab_size)
        for g in range(untraced):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = model.decode_sample(params, cache, tok, S + g,
                                             noise, head)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for g in range(untraced, steps):
                tok, cache = model.decode_sample(params, cache, tok, S + g,
                                                 noise, head)
            torch.cuda.synchronize()
    kernels = profile_serve._device_events(prof)
    k6 = [e for e in kernels
          if any(f in e.key for f in profile_serve.KERNELS["k6"])]
    out = {"host_ms": float(np.median(host[1:])),
           "device_ms": profile_serve._ms(kernels) / traced,
           "k6_ms": profile_serve._ms(k6) / traced,
           "launches": sum(e.count for e in kernels) / traced,
           "top": profile_serve._tops(kernels, traced, "ms_per_step")[:5]}
    del prof, cache, head, model
    torch.cuda.empty_cache()
    return out


def mla_naive_hold(cfg, params, cache, tok, S, steps):
    """13b: the reference's two MLA decode paths, absorbed (the default:
    attention in the latent space) and naive (K and V rebuilt from the
    latent every step), each from its own clone of one prefill cache,
    teacher-forced on the absorbed path's greedy tokens, every step's
    routing recorded on both. A row whose routing differed in a step (a
    near tie, held as such) parts there; on the other rows the logits are
    held within 1e-4·max|logit| and the naive path's ids under the
    near-tie rule. Returns (largest logit error, its bound, near-tie
    exceptions, ids compared, routing differences, {row: step it
    parted})."""
    K = cfg.moe.top_k
    absorbed = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    naive = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                             mla_absorbed=False))
    clone = lambda c: tree_map(lambda t: t.clone(), c)
    cache_a, cache_n = clone(cache), clone(cache)
    live = torch.ones(tok.shape[0], dtype=torch.bool, device=DEV)
    lerr = lbound = 0.0
    ties = compared = flips = 0
    parted = {}
    with torch.inference_mode():
        for g in range(steps):
            with RouteRecorder(moe_mod) as ra:
                la, cache_a = absorbed.decode(params, cache_a, tok, S + g)
            with RouteRecorder(moe_mod) as rn:
                ln, cache_n = naive.decode(params, cache_n, tok, S + g)
            try:
                r = hold_routing(rn.calls, ra.calls, K, MOE_FLIP_FACTOR,
                                 live=live)
            except AssertionError as e:
                raise RuntimeError(f"chip_smoke: MLA naive decode step {g}: "
                                   f"{e}")
            flips += r["flips"]
            for b in r["rows"]:
                parted[b] = g
                live[b] = False
            want = sample_ids(la, 0.0, cfg.vocab_size)
            rows = torch.nonzero(live).flatten()
            if rows.numel():
                e = float((ln[rows] - la[rows]).abs().max())
                bound = 1e-4 * float(la[rows].abs().max())
                check(e <= bound, f"MLA naive decode step {g}: logits "
                      f"differ by {e:.3e} (bound {bound:.3e})")
                lerr, lbound = max(lerr, e), max(lbound, bound)
                t, bad = ref.near_tie_check(
                    la[rows], sample_ids(ln, 0.0, cfg.vocab_size)[rows],
                    want[rows], cfg.vocab_size)
                check(bad == 0, f"MLA naive decode step {g}: ids break the "
                      f"near-tie rule")
                ties += t
                compared += int(rows.numel())
            tok = want
    del cache_a, cache_n
    return lerr, lbound, ties, compared, flips, parted


def dsv2_phase():
    """13a: deepseek-v2-236b at full width, 4 layers, served through K4 (its
    4 layers' prefill, MLA at D = 192 with V padded) and K6 (the untied
    102,400-row head), the decode absorbed in the latent space on tensor
    ops; the prefill's device time by kernel, the decode step's device and
    host times, the share of routed choices dropped per MoE layer. 13b: K4
    held layer by layer against the chunked plain route and end to end,
    the absorbed decode against the naive one, the K6 ids against the
    plain decode's matmul + argmax, teacher-forced; every routing
    difference a near tie. 13c: continuous batching on 8 slots (MLA's
    per-slot decode positions), three requests held against solo
    serving."""
    check(torch.cuda.memory_allocated() < 2 ** 30, "phase 13 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    register_dsv2()
    cfg = get_config(DSV2_ARCH)
    check(cfg.param_count() == DSV2_PARAMS and transformer._n_prefix(cfg) == 1
          and moe_mod._capacity(DSV2["prompt_len"], cfg.moe) == DSV2_CAPACITY,
          f"{DSV2_ARCH}'s config")
    steps = DSV2["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print(f"[chip_smoke] 13a deepseek-v2 serve path: serve('{DSV2_ARCH}', "
          f"reduced=False, {flags}, {DSV2}); {cfg.param_count()} parameters "
          f"({cfg.active_param_count()} active a token; "
          f"{cfg.param_count() * 4 / 2 ** 30:.2f} GiB), {N_DSV2_LAYERS} of "
          f"the 60 layers, capacity {DSV2_CAPACITY} a row in the prefill",
          flush=True)
    res, counts, peak = serve_path(
        DSV2_ARCH, DSV2, {"k4": N_DSV2_LAYERS, "k5": 0, "k6": steps,
                          "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    tok_s = res.timings["tok_per_s"]
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = full_params(DSV2_ARCH)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[chip_smoke]   the weights' init alone peaks at {init_peak:.2f} "
          f"GiB (the stack, and one block beside it while it is drawn)",
          flush=True)
    prof = prefill_profile(cfg, params, DSV2, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_DSV2_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    print(f"[chip_smoke]   routing's sort / scatter / gather / index "
          f"kernels: {prof['prefill_dispatch_ms']:.2f} ms", flush=True)
    dec = decode_profile(cfg, params, DSV2, **flags)
    print(f"[chip_smoke]   decode step (B={DSV2['batch']}, C "
          f"{DSV2['prompt_len']}+): device {dec['device_ms']:.2f} ms (K6 "
          f"{dec['k6_ms']:.3f} ms, {dec['launches']:.0f} kernels), host "
          f"median {dec['host_ms']:.2f} ms; top "
          f"{[(e['name'][:40], round(e['ms_per_step'], 2)) for e in dec['top']]}",
          flush=True)
    B, S, G = DSV2["batch"], DSV2["prompt_len"], DSV2["gen_len"]
    prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
    chunked = Lyr.AttnCall(chunk=1024)
    k4r, lflips, lworst, leps, xerr = moe_layer_hold(cfg, params, prompt,
                                                     chunked)
    print(f"[chip_smoke] 13b K4 layer by layer (the chunked plain route's "
          f"input to each of {N_DSV2_LAYERS} layers): K4 at {k4r:.3f} of its "
          f"bound at worst; routing differences {lflips} (worst margin at "
          f"{lworst:.3f} of {MOE_FLIP_FACTOR}·eps), router probabilities "
          f"within {leps:.3e}, block outputs within {xerr:.3e} where the "
          f"routing agreed", flush=True)
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                             attn_chunk=1024,
                                             dense_attn_max=1024))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    e2e, cache_p, tok = moe_prefill_hold(cfg, params, prompt, S, G, plain,
                                         kern)
    r, d = e2e["routing"], e2e["drops"]
    print(f"[chip_smoke] 13b K4 prefill vs chunked prefill end to end: "
          f"routing differences {r['flips']} token-layers ({r['first']} "
          f"first differences, margins {[f'{m:.2e}' for m in r['margins']]},"
          f" worst at {r['worst']:.3f} of {MOE_FLIP_FACTOR}·eps), rows with "
          f"a difference {r['rows']}; last logits max abs by row "
          f"{[f'{e:.3e}' for e in e2e['lerr']]} (bound {e2e['lbound']:.3e} "
          f"held on rows {e2e['clean']}), first ids equal "
          f"{e2e['ids_equal']}/{B}, near-tie exceptions {e2e['ties']}; "
          f"cache layers at {e2e['cratio']:.3f} of their bounds "
          f"({e2e['cache_rows_held']} layer-rows held)", flush=True)
    print(f"[chip_smoke] 13a routed choices dropped by capacity (C = "
          f"{DSV2_CAPACITY}, the serve's prompt and weights, K4 route) per "
          f"MoE layer: {[f'{x * 100:.2f} %' for x in d]}", flush=True)
    nerr, nbound, nties, n_naive, nflips, nparted = mla_naive_hold(
        cfg, params, cache_p, tok, S, DSV2_NAIVE_STEPS)
    print(f"[chip_smoke] 13b MLA absorbed vs naive decode from one cache, "
          f"teacher-forced {DSV2_NAIVE_STEPS} steps: logits max abs "
          f"{nerr:.3e} (bound {nbound:.3e}), {n_naive} ids, near-tie "
          f"exceptions {nties}; routing differences {nflips} (rows parted "
          f"at a near tie: {nparted})", flush=True)
    dkern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                             use_decode_kernel=True))
    dties, n_ids, dflips, parted = moe_decode_hold(cfg, params, cache_p,
                                                   tok, S, G, dkern, plain)
    del cache_p
    torch.cuda.empty_cache()
    print(f"[chip_smoke] 13b K6 decode vs plain (matmul + argmax) from one "
          f"cache, teacher-forced: {n_ids} ids, near-tie exceptions "
          f"{dties}; routing differences {dflips} (rows parted at a near "
          f"tie: {parted})", flush=True)
    print(f"[chip_smoke] 13c serve_continuous('{DSV2_ARCH}', reduced=False, "
          f"{flags}, {DSV2_TRACE})", flush=True)
    cres, ccounts, _, _ = continuous_check(
        DSV2_ARCH, params, DSV2_TRACE, flags, flags, {"k4": N_DSV2_LAYERS}, 0)
    cm = cres.metrics
    del params, kern, dkern, plain, cres
    torch.cuda.empty_cache()
    return {"counts": counts, "ccounts": ccounts, "peak": peak,
            "init_peak": init_peak, "prefill": prof, "decode": dec,
            "step_ms": step_ms,
            "ttft_ms": ttft_ms, "tok_s": tok_s, "drops": d,
            "e2e_flips": r["flips"], "layer_flips": lflips,
            "naive_flips": nflips, "decode_flips": dflips,
            "ring_p50_ms": cm["p50_step_s"] * 1e3}


def frontend_phase(arch, kw, n_layers, tag):
    """13d / 13e: ``arch`` (musicgen-large's frame embeddings, internvl2-1b's
    patches before the text) served at full width and depth through K4
    (every layer), K5 and K6; its prefill's device time by kernel; the K4
    prefill held against the plain one (dense at these prompt lengths) and
    the K5/K6 decode against the plain decode, teacher-forced from one
    cache (11b's holds)."""
    cfg = get_config(arch)
    check(cfg.n_layers == n_layers, f"{arch}'s config")
    steps = kw["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print(f"[chip_smoke] {tag} {arch} serve path: serve('{arch}', "
          f"reduced=False, {flags}, {kw}); family {cfg.family}, "
          f"{cfg.param_count()} parameters", flush=True)
    res, counts, peak = serve_path(
        arch, kw, {"k4": n_layers, "k5": K5_PER_CALL * n_layers * steps,
                   "k6": steps, "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    tok_s = res.timings["tok_per_s"]
    del res
    cfg, params = full_params(arch)
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    if cfg.tie_embeddings:
        check(kern.sample_head(params)[0].data_ptr()
              == params["embed"]["table"].data_ptr(),
              f"K6's head is a copy of {arch}'s tied table")
    prof = prefill_profile(cfg, params, kw, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == n_layers,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    # as the long-prompt K4 path: 1e-4 of the largest logit
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, kw, dict(use_flash_kernel=True), lambda: 1e-4, arch)
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok,
                                     kw["prompt_len"], kw["gen_len"], kern,
                                     plain, arch)
    print(f"[chip_smoke] {tag} K4 prefill vs dense plain prefill, full "
          f"width: last logits max abs {lerr:.3e} (bound {lbound:.3e}), "
          f"cache leaves at {cratio:.3f} of their bounds at worst, first "
          f"ids near-tie exceptions {ties}; K5/K6 decode vs plain from one "
          f"cache: {n_ids} ids, near-tie exceptions {dties}", flush=True)
    del params, cache_p, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "peak": peak, "prefill": prof,
            "step_ms": step_ms, "ttft_ms": ttft_ms, "tok_s": tok_s,
            "lerr": lerr, "lbound": lbound, "ties": ties, "dties": dties}


def phase13_kernels(gen):
    """13f: K4 at MLA's prefill shape (q and k at D = 192, V padded from
    128, as ``models/mla.py`` calls it; its bound on the true dims), at
    musicgen's and internvl2's, K5 at their decode shapes and K6 at
    deepseek-v2's, musicgen's and internvl2's heads, held against their
    plain versions; K4 (MLA, musicgen), K5 (musicgen) and K6 (deepseek-v2)
    timed, SDPA and matmul + argmax beside them."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0}
    for shape in (K4_MLA, K4_MUSICGEN, K4_INTERNVL):
        err, bound = k4_case(*shape, 0, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={shape}: max abs {err:.3e} "
              f"(bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at {shape}")
    for shape in (K5_MUSICGEN, K5_INTERNVL):
        err, bound = k5_case(*shape, 0.0, gen)
        out["k5_err"] = max(out["k5_err"], err)
        print(f"[chip_smoke] K5 B,C,Hk,rep,D={shape} plan "
              f"{ds.attention_plan(shape[0], shape[2], shape[1])}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, f"K5 differs from its plain version at {shape}")
    for name, head, B_ in (("deepseek-v2", DSV2_HEAD, DSV2["batch"]),
                           ("deepseek-v2 ring", DSV2_HEAD,
                            DSV2_TRACE["slots"]),
                           ("musicgen", MUSICGEN_HEAD, MUSICGEN["batch"]),
                           ("internvl2", INTERNVL_HEAD, INTERNVL["batch"])):
        for greedy in (True, False):
            ties, bad, err = k6_case(B_, greedy, gen, head=head)
            out["k6_err"] = max(out["k6_err"], err)
            print(f"[chip_smoke] K6 {name} head B={B_} "
                  f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
                  f"{ties}, violations {bad}, winning logit max abs "
                  f"{err:.3e}", flush=True)
            check(bad == 0, f"K6 breaks the near-tie rule at {name}'s head")
    out["k4"] = {"mla": time_k4(gen, K4_MLA, dv=MLA_DV),
                 "musicgen": time_k4(gen, K4_MUSICGEN)}
    out["k5"] = time_k5(K5_MUSICGEN, gen)
    out["k6"] = time_k6(gen, DSV2["batch"], DSV2_HEAD)
    for key, t in out["k4"].items():
        print(f"[chip_smoke] K4 at {key}'s prefill shape: {t['ms']:.3f} "
              f"ms/launch (device {t['device_ms']:.3f} ms), plain "
              f"{t['plain_ms']:.3f} ms, chunked {t['chunked_ms']:.3f} ms, "
              f"SDPA {t['library_ms']:.3f} ms ({t['library_backend']}), "
              f"bound {t['bound_ms']:.3f} ms ({t['flops'] / 1e9:.2f} GFLOP), "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound on "
              f"device time", flush=True)
    t = out["k5"]
    print(f"[chip_smoke] K5 at musicgen's decode shape {K5_MUSICGEN}: "
          f"{t['ms'] * 1e3:.2f} us/call back to back, device "
          f"{t['device_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
          f"us (device {t['plain_device_ms'] * 1e3:.2f}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{t['library_device_ms'] * 1e3:.2f}; {t['library_backend']}), "
          f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    t = out["k6"]
    print(f"[chip_smoke] K6 at deepseek-v2's head (B={DSV2['batch']}): "
          f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"matmul + argmax {t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    return out


def phase13(gen):
    """Phase 13: 13a-13c (deepseek-v2, 4 layers), 13d (musicgen-large),
    13e (internvl2-1b), then the kernels at their shapes (13f)."""
    t0 = time.perf_counter()
    dsv = dsv2_phase()
    mus = frontend_phase(MUSICGEN_ARCH, MUSICGEN, N_MUSICGEN_LAYERS, "13d")
    ivl = frontend_phase(INTERNVL_ARCH, INTERNVL, N_INTERNVL_LAYERS, "13e")
    ks = phase13_kernels(gen)
    p = dsv["prefill"]
    print(f"[chip_smoke] phase 13: {time.perf_counter() - t0:.1f} s; "
          f"deepseek-v2 (4 layers) serve peak {dsv['peak']:.2f} GiB (its "
          f"init alone {dsv['init_peak']:.2f}), TTFT "
          f"{dsv['ttft_ms']:.1f} ms, median step {dsv['step_ms']:.2f} ms "
          f"({dsv['tok_s']:.2f} tokens/s), ring p50 step "
          f"{dsv['ring_p50_ms']:.2f} ms; its prefill's device time "
          f"{p['prefill_device_ms']:.1f} ms (K4 {p['prefill_k4_ms']:.2f} ms "
          f"against a bound of "
          f"{N_DSV2_LAYERS * ks['k4']['mla']['bound_ms']:.2f} ms, GEMMs "
          f"{p['prefill_gemm_ms']:.1f}, routing "
          f"{p['prefill_dispatch_ms']:.1f}, rest "
          f"{p['prefill_other_ms'] - p['prefill_dispatch_ms']:.1f}); "
          f"musicgen peak {mus['peak']:.2f} GiB, TTFT {mus['ttft_ms']:.1f} "
          f"ms, step {mus['step_ms']:.2f} ms, prefill "
          f"{mus['prefill']['prefill_device_ms']:.1f} ms of device time; "
          f"internvl2 peak {ivl['peak']:.2f} GiB, TTFT {ivl['ttft_ms']:.1f} "
          f"ms, step {ivl['step_ms']:.2f} ms, prefill "
          f"{ivl['prefill']['prefill_device_ms']:.1f} ms", flush=True)
    return {"dsv2": dsv, "musicgen": mus, "internvl2": ivl, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 14: the mesh layer on a 1×1 card mesh, and the examples
# --------------------------------------------------------------------------- #

MESH_ARGV = ["--arch", "qwen2-0.5b", "--method", "savic", "--rounds", "2",
             "--h-local", "2", "--batch", "8", "--seq", "128", "--device",
             "cuda"]


def mesh_case(label, extra, expect_k1, expect_k3=0):
    """``train.main --mesh debug --mesh-shape 1x1`` (a 1-rank NCCL group
    started and destroyed by the run) against ``--mesh none --clients 1``
    with the same arguments: every deterministic field of every record
    (loss, drift, compression_err, wire_bytes, the controller's knobs and
    observations, ...) and every leaf of the final state bitwise (each
    run's state copied to the host, so that the two peaks are alike); K1
    and K3 launched as many times as expected in each run. Returns the
    mesh run's K1 and K3 launches, round walls, peak GiB and seconds, and
    the unsharded run's peak."""
    out = {}
    for mesh in (True, False):
        argv = MESH_ARGV + list(extra) + (
            ["--mesh", "debug", "--mesh-shape", "1x1"] if mesh
            else ["--clients", "1"])
        print(f"[chip_smoke] {label}: train.main " + " ".join(argv),
              flush=True)
        reset_counts()
        qu.quantize_update_flat.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        log, state = train.main(argv, return_state=True)
        secs = time.perf_counter() - t0
        k1, k3 = su.fused_step_flat.launches, qu.quantize_update_flat.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(k1 == expect_k1, f"{label}: K1 launched {k1} times, expected "
              f"{expect_k1}")
        check(k3 == expect_k3, f"{label}: K3 launched {k3} times, expected "
              f"{expect_k3}")
        for rec in log:
            check(all(finite(v) for v in rec.values()
                      if isinstance(v, float)), f"non-finite record {rec}")
        out[mesh] = (log, tree_map(lambda t: t.cpu(), state), k1, peak, secs)
        del state
    (lm, sm, k1, peak, secs), (ln, sn, _, peak_n, _) = out[True], out[False]
    check(len(lm) == len(ln), f"{label}: {len(lm)} rounds vs {len(ln)}")
    for a, b in zip(lm, ln):
        check(det(a) == det(b), f"{label}: round {a['round']} differs from "
              f"--mesh none: {det(a)} vs {det(b)}")
    pm, pn = tree_paths(sm), tree_paths(sn)
    same = [pa == pb and torch.equal(a, b)
            for (pa, a), (pb, b) in zip(pm, pn)]
    check(len(pm) == len(pn) and all(same),
          f"{label}: the final state differs from --mesh none")
    walls = [r["wall_s"] for r in lm]
    k3 = expect_k3
    print(f"[chip_smoke] {label}: losses {[r['loss'] for r in lm]}, every "
          f"record's {sorted(det(lm[0]))} bitwise --mesh none's, "
          f"{len(same)} state leaves bitwise; K1 {k1}, K3 {k3}; round walls "
          f"{walls} s (--mesh none {[r['wall_s'] for r in ln]}); peak "
          f"{peak:.2f} GiB (--mesh none {peak_n:.2f}); {secs:.1f} s",
          flush=True)
    del out, sm, sn, pm, pn
    torch.cuda.empty_cache()
    return {"k1": k1, "k3": k3, "walls": walls, "peak": peak, "secs": secs,
            "peak_none": peak_n, "log": lm}


def run_example(name, argv):
    """``examples/<name>.py``'s ``main(argv)`` on the card; its rows."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    rows = mod.main(argv)
    print(f"[chip_smoke] 14c {name} {' '.join(argv)}: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(all(finite(v) for r in rows for v in r if isinstance(v, float)),
          f"{name}: non-finite rows")
    return rows


def phase14():
    """Phase 14: the mesh layer on a 1×1 card mesh at full-width qwen2-0.5b
    (14a paper on the tree loop, 14b plain on K1), then the examples
    (14c)."""
    import tempfile
    t0 = time.perf_counter()
    a = mesh_case("14a mesh 1x1 paper", ["--mode", "paper"], 0)
    b = mesh_case("14b mesh 1x1 plain, K1", ["--mode", "plain",
                                             "--use-fused-kernel"],
                  2 * H_LOCAL)
    run_example("quickstart_torch", ["--device", "cuda"])
    out = tempfile.mkdtemp()
    try:
        run_example("federated_heterogeneity_torch",
                    ["--rounds", "3", "--device", "cuda", "--out",
                     os.path.join(out, "fig1.csv")])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] phase 14: {secs:.1f} s; 14a {a['secs']:.1f} s "
          f"(peak {a['peak']:.2f} GiB), 14b {b['secs']:.1f} s (peak "
          f"{b['peak']:.2f} GiB, K1 {b['k1']})", flush=True)
    return {"a": a, "b": b, "secs": secs}


# --------------------------------------------------------------------------- #
# phase 15: the dry run's cost model against the card
# --------------------------------------------------------------------------- #

DRY_CASES = {"14a": ["--mode", "paper"],
             "14b": ["--mode", "plain", "--use-fused-kernel"]}
DRY_OUT = os.path.join(ROOT, ".chip_smoke_dryrun")     # git-ignored


def mesh_argv(extra):
    return MESH_ARGV + list(extra) + ["--mesh", "debug", "--mesh-shape",
                                      "1x1"]


def predict_rounds(timeout=600):
    """15a: two child processes, each with a fake process group of its own
    (never beside phase 14's NCCL group), predict one round of each 14a /
    14b ``train.main`` run (``dryrun --train-argv``). They run while no
    timed phase runs, and nothing of them outlives this call. Returns their
    records and wall seconds."""
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    os.makedirs(DRY_OUT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs, out = {}, {}
    try:
        for label, extra in DRY_CASES.items():
            log = open(os.path.join(DRY_OUT, f"{label}.log"), "w")
            procs[label] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--train-argv", " ".join(mesh_argv(extra)), "--tag", label,
                 "--out", DRY_OUT], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log, time.perf_counter())
        for label, (proc, log, t0) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, timeout - (
                    time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            secs = time.perf_counter() - t0
            with open(log.name) as f:
                text = f.read()
            check(rc == 0, f"dry run {label} exited {rc}:\n{text[-4000:]}")
            with open(os.path.join(
                    DRY_OUT,
                    f"qwen2-0.5b__train_cli_128__1x1__{label}.json")) as f:
                out[label] = (json.load(f), secs)
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return out


def nbytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def card_rounds(label, argv, flops):
    """``train.main(argv)`` on the card with each round's arguments' bytes
    and CUDA-event time read around the round step; under
    ``FlopCounterMode`` when ``flops`` (K4 and K4b counted by their FLOP
    formulas). Returns the log, K1 launches, peak bytes, per-round argument
    bytes and device ms, and the FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import steps as steps_mod
    args_b, dev_ms, orig = [], [], steps_mod.build_train_step

    def build(*a, **k):
        built = orig(*a, **k)
        fn = built.fn

        def step(state, batch, stream=None):
            args_b.append(nbytes((state, batch)))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(state, batch, stream)
            e1.record()
            e1.synchronize()
            dev_ms.append(e0.elapsed_time(e1))
            return out
        built.fn = step
        return built

    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps_mod.build_train_step = build
    counter = FlopCounterMode(display=False) if flops \
        else contextlib.nullcontext()
    try:
        with counter:
            log = train.main(argv)
    finally:
        steps_mod.build_train_step = orig
    peak = torch.cuda.max_memory_allocated()
    total = counter.get_total_flops() if flops else None
    print(f"[chip_smoke] 15b {label}{' under FlopCounterMode' if flops else ''}"
          f": losses {[r['loss'] for r in log]}, K1 "
          f"{su.fused_step_flat.launches}, round walls "
          f"{[r['wall_s'] for r in log]} s, device {dev_ms} ms", flush=True)
    return {"log": log, "k1": su.fused_step_flat.launches, "peak": peak,
            "args": args_b, "dev_ms": dev_ms, "flops": total}


def phase15():
    """Phase 15: the dry run's predictions (15a) against the same rounds on
    the card (15b): FLOPs, K1 launches and argument bytes equal; the peak
    and the roofline round time beside the measured ones, as ratios."""
    t0 = time.perf_counter()
    preds = predict_rounds()
    real = {}
    for label, extra in DRY_CASES.items():
        argv = mesh_argv(extra)
        print(f"[chip_smoke] 15b {label}: train.main " + " ".join(argv),
              flush=True)
        real[label] = card_rounds(label, argv, flops=False)
        real[label]["flops"] = card_rounds(label, argv, flops=True)["flops"]
    out = {}
    for label in DRY_CASES:
        (rec, secs), r = preds[label], real[label]
        rounds = len(r["log"])
        k1_pred = rec["custom_counts"].get("repro_torch.fused_step_flat", 0)
        arg_pred = rec["memory"]["argument_size_in_bytes"]
        bound_s = max(rec["roofline"][k] for k in ("compute_s", "memory_s",
                                                    "collective_s"))
        walls = [x["wall_s"] for x in r["log"]]
        print(f"[chip_smoke] 15 {label}: FLOPs predicted {rounds} × "
              f"{rec['flops']} = {rounds * rec['flops']}, measured "
              f"{r['flops']}; K1 predicted {rounds} × {k1_pred}, measured "
              f"{r['k1']}; argument bytes predicted {arg_pred}, measured "
              f"{r['args']}; peak predicted {rec['peak_bytes']} B, measured "
              f"{r['peak']} B (measured / predicted "
              f"{r['peak'] / rec['peak_bytes']:.4f}); roofline round "
              f"{bound_s * 1e3:.3f} ms ({rec['roofline']['dominant']}: "
              f"compute {rec['roofline']['compute_s'] * 1e3:.3f}, memory "
              f"{rec['roofline']['memory_s'] * 1e3:.3f} ms), device "
              f"{r['dev_ms']} ms (ratio "
              f"{[round(d / 1e3 / bound_s, 3) for d in r['dev_ms']]}), wall "
              f"{walls} s (ratio "
              f"{[round(w / bound_s, 3) for w in walls]}); predicted in "
              f"{rec['trace_s']} s of tracing ({secs:.1f} s in its process)",
              flush=True)
        check(r["flops"] == rounds * rec["flops"],
              f"{label}: FLOPs differ from the dry run's")
        check(r["k1"] == rounds * k1_pred,
              f"{label}: K1 launches differ from the dry run's")
        check(r["args"] == [arg_pred] * rounds,
              f"{label}: argument bytes differ from the dry run's")
        out[label] = {"pred": rec, "real": r, "bound_s": bound_s}
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] phase 15: {secs:.1f} s", flush=True)
    return {"cases": out, "secs": secs}


# --------------------------------------------------------------------------- #
# phase 16: the mesh features on a 1×1 card mesh
# --------------------------------------------------------------------------- #

CKPT_16 = os.path.join(ROOT, ".chip_smoke_ckpt16")    # on disk, git-ignored


def knobs_line(log):
    return "; ".join(
        f"round {r['round']} H_m {r['ctrl_h_m']} H_t {r['ctrl_h_t']} k "
        f"{r['ctrl_k']} b_eff {r['ctrl_b_eff']} gns_ema {r['ctrl_gns_ema']}"
        for r in log)


def ckpt_run(label, argv, expect_k1, restores=0):
    """One ``train.main(argv, return_state=True)`` under ``CkptIO``, with
    its records checked finite and K1 counted; returns the log, the final
    state on the host, the saves and restores, K1 and the round's peak."""
    print(f"[chip_smoke] {label}: train.main " + " ".join(argv), flush=True)
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CkptIO(save_peaks=True) as io:
        log, state = train.main(argv, return_state=True)
    k1 = su.fused_step_flat.launches
    check(k1 == expect_k1, f"{label}: K1 launched {k1} times, expected "
          f"{expect_k1}")
    check(len(io.restores) == restores, f"{label}: {len(io.restores)} "
          f"restores, expected {restores}")
    for rec in log:
        check(all(finite(v) for v in rec.values() if isinstance(v, float)),
              f"non-finite record {rec}")
    state = tree_map(lambda t: t.cpu(), state)
    torch.cuda.empty_cache()
    return {"log": log, "state": state, "io": io, "k1": k1}


def same_state(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    return len(pa) == len(pb) and all(
        x == y and torch.equal(u, v) for (x, u), (y, v) in zip(pa, pb))


def mesh_ckpt_case():
    """16c: ``--mode plain --use-fused-kernel --rounds 4 --ckpt`` at full
    width cut to 2 layers (2.0 GB steps; the 24-layer model's 5.93 GB
    saves and their hashes took most of phase 16): on the 1×1 mesh
    straight (saving round 4) and as 2 rounds (saving round 2)
    then a resume to 4, against ``--mesh none --clients 1`` saving rounds
    2 and 4. Records and final states bitwise; the mesh's data.bin at
    rounds 2 and 4 byte for byte the unsharded run's (sha256)."""
    shutil.rmtree(CKPT_16, ignore_errors=True)
    os.makedirs(CKPT_16)
    free = shutil.disk_usage(CKPT_16).free
    # two steps of params, momentum and D at M = 1, fp32, at a time
    need = 2 * 3 * 4 * tree_n(get_config(register_cut("qwen2-0.5b", 2)))
    check(free > need + (1 << 30), f"16c: {free} B free, {need} B needed")
    base = ["--arch", ARCH_2L] + MESH_ARGV[2:] + ["--mode", "plain",
                                                  "--use-fused-kernel"]
    mesh = ["--mesh", "debug", "--mesh-shape", "1x1"]
    d = {k: os.path.join(CKPT_16, k) for k in ("none", "straight", "split")}
    per = lambda T, every, dd: ["--rounds", str(T), "--ckpt", dd,
                                "--ckpt-every", str(every)]
    try:
        n = ckpt_run("16c --mesh none", base + ["--clients", "1"]
                     + per(4, 2, d["none"]), 4 * H_LOCAL)
        sha = {f"none{s}": sha256_file(os.path.join(
            d["none"], f"step_{s:08d}", "data.bin")) for s in (2, 4)}
        shutil.rmtree(d["none"])
        a = ckpt_run("16c mesh straight", base + mesh
                     + per(4, 4, d["straight"]), 4 * H_LOCAL)
        sha["straight4"] = sha256_file(os.path.join(
            d["straight"], "step_00000004", "data.bin"))
        shutil.rmtree(d["straight"])
        b1 = ckpt_run("16c mesh, first 2 rounds", base + mesh
                      + per(2, 2, d["split"]), 2 * H_LOCAL)
        sha["split2"] = sha256_file(os.path.join(
            d["split"], "step_00000002", "data.bin"))
        b2 = ckpt_run("16c mesh, resumed to 4", base + mesh
                      + per(4, 2, d["split"]), 2 * H_LOCAL, restores=1)
        sha["split4"] = sha256_file(os.path.join(
            d["split"], "step_00000004", "data.bin"))
    finally:
        shutil.rmtree(CKPT_16, ignore_errors=True)
    check([r["round"] for r in b2["log"]] == [2, 3],
          f"16c: the resumed run logged {[r['round'] for r in b2['log']]}")
    for ra, rn, rb in zip(a["log"], n["log"], b1["log"] + b2["log"]):
        check(det(ra) == det(rn) == det(rb), f"16c: round {ra['round']} "
              f"differs: {det(ra)} / {det(rn)} / {det(rb)}")
    check(same_state(a["state"], n["state"])
          and same_state(a["state"], b2["state"]),
          "16c: the final states differ")
    check(sha["split2"] == sha["none2"], "16c: the mesh's round-2 data.bin "
          "differs from --mesh none's")
    check(sha["straight4"] == sha["none4"] == sha["split4"],
          "16c: the round-4 data.bin differs")
    saves = [s for r in (n, a, b1, b2) for s in r["io"].saves]
    print(f"[chip_smoke] 16c: 4 rounds on the mesh straight, 2 + restore + "
          f"2, and --mesh none: every record and the final state bitwise; "
          f"data.bin at round 2 {sha['none2'][:16]}… and round 4 "
          f"{sha['none4'][:16]}… byte-equal; K1 {a['k1']} vs {b1['k1']} + "
          f"{b2['k1']}; mesh straight: {io_line(a['io'])}; split: "
          f"{io_line(b1['io'])}; {io_line(b2['io'])}; --mesh none: "
          f"{io_line(n['io'])}", flush=True)
    return {"k1": a["k1"] + b1["k1"] + b2["k1"], "saves": saves,
            "restores": b2["io"].restores,
            "walls": [r["wall_s"] for r in a["log"]]}


def phase16():
    """Phase 16: the mesh features on a 1×1 card mesh at full-width
    qwen2-0.5b, each run bitwise ``--mesh none --clients 1``'s: 16a
    compression (int8 + EF on K1 and K3, a rank's flat block and leaf
    blocks; top-k + EF on the tree loop), 16b the controller with a FIFO
    and a client objective, 16c checkpoints and a bitwise resume."""
    t0 = time.perf_counter()
    a = mesh_case("16a mesh 1x1 plain, K1 + K3 int8 + EF",
                  ["--mode", "plain", "--use-fused-kernel", "--compression",
                   "int8-stochastic", "--error-feedback"], 2 * H_LOCAL,
                  2 * N_LEAVES)
    t = mesh_case("16a mesh 1x1 paper, topk + EF",
                  ["--mode", "paper", "--compression", "topk",
                   "--compression-k", "0.1", "--error-feedback"], 0)
    b = mesh_case("16b mesh 1x1 paper, controller + FIFO 2 + consistency",
                  ["--mode", "paper", "--controller", "--async-buffer", "2",
                   "--het-model", "lognormal", "--objective", "consistency",
                   "--labeled-frac", "0.5", "--rounds", "3"], 0)
    print(f"[chip_smoke] 16b knobs, equal to --mesh none's: "
          f"{knobs_line(b['log'])}", flush=True)
    c = mesh_ckpt_case()
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] phase 16: {secs:.1f} s; 16a int8 {a['secs']:.1f} s "
          f"(walls {a['walls']} s, peak {a['peak']:.2f} GiB, --mesh none "
          f"{a['peak_none']:.2f}), topk {t['secs']:.1f} s (walls "
          f"{t['walls']} s, peak {t['peak']:.2f} GiB, --mesh none "
          f"{t['peak_none']:.2f}); 16b {b['secs']:.1f} s (walls "
          f"{b['walls']} s, peak {b['peak']:.2f} GiB, --mesh none "
          f"{b['peak_none']:.2f}); 16c walls {c['walls']} s", flush=True)
    return {"a": a, "topk": t, "b": b, "c": c, "secs": secs}


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def finite(v):
    return v == v and abs(v) != float("inf")


def main_path(argv, expect_k1, expect_k3=0, expect_k4b=None):
    """Drive ``train.main(argv)`` with the kernels' counts (K1, K3; K7 and
    K7b, which an SSM's differentiated SSD takes on the card; K4 and K4b,
    which differentiated attention takes) set to 0 just before and read
    just after; returns (log, K1 launches, K3 launches, peak GiB); K4's,
    K4b's, K7's and K7b's counts stay on their wrappers' ``launches`` until
    the next run. ``expect_k1`` is a count, or a function of the log (the
    launches the realized H_m need: one a local step in which any client is
    active, Σ_r max_m H_m,r); ``expect_k4b`` (``k4b_calls``), where given,
    K4b's calls, and K4 launches twice as many (forward and remat
    recompute)."""
    su.fused_step_flat.launches = 0
    qu.quantize_update_flat.launches = 0
    ssd.ssd_intra_chunk.launches = ssd.ssd_intra_chunk_bwd.launches = 0
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = train.main(argv)
    k1, k3 = su.fused_step_flat.launches, qu.quantize_update_flat.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rec in log:
        extra = (f" comp_err {rec['compression_err']:.4e}"
                 if "compression_err" in rec else "")
        extra += (f" staleness {rec['staleness']:.4f}"
                  if "staleness" in rec else "")
        extra += (f" H_m {rec['ctrl_h_m']} H_t {rec['ctrl_h_t']} k "
                  f"{rec['ctrl_k']} b_eff {rec['ctrl_b_eff']}"
                  if "ctrl_h_m" in rec else "")
        print(f"[chip_smoke]   round {rec['round']} loss {rec['loss']:.5f} "
              f"drift {rec['drift']:.4e}{extra} tokens/s "
              f"{rec['tokens_per_s']} wall {rec['wall_s']} s", flush=True)
        check(all(finite(v) for v in rec.values() if isinstance(v, float)),
              f"non-finite record {rec}")
        check("staleness" not in rec or rec["staleness"] >= 0.0,
              f"staleness {rec.get('staleness')}")
    if callable(expect_k1):
        expect_k1 = expect_k1(log)
    check(k1 == expect_k1, f"K1 launched {k1} times, expected {expect_k1}")
    check(k3 == expect_k3, f"K3 launched {k3} times, expected {expect_k3}")
    k4, k4b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    check(expect_k4b is None or (k4b == expect_k4b and k4 == 2 * k4b),
          f"K4 launched {k4} times, K4b {k4b}; expected "
          f"{2 * (expect_k4b or 0)} and {expect_k4b}")
    print(f"[chip_smoke]   launches K1 {k1}, K3 {k3}, K4 {k4}, K4b {k4b}, "
          f"K7 {ssd.ssd_intra_chunk.launches}, K7b "
          f"{ssd.ssd_intra_chunk_bwd.launches}; peak memory {peak:.2f} GiB",
          flush=True)
    return log, k1, k3, peak


def k4_layers(cfg):
    """Attention applications of a forward that take K4 + K4b on the card
    (``layers._takes_k4``: fp32 compute, D <= 128 a multiple of 4): a
    pattern stack's ``*`` layers, the hybrid's shared-block applications,
    every layer of the other transformer families; none for an SSM, MLA or
    gemma3's D 256."""
    if cfg.family == "ssm" or cfg.mla \
            or not fa.bwd_takes(cfg.head_dim, torch.float32):
        return 0
    if cfg.layer_kinds:
        return cfg.layer_kinds.count("*")
    if cfg.family == "hybrid":
        return sum(transformer._applies_shared(cfg, i)
                   for i in range(cfg.n_layers))
    return cfg.n_layers


def k4b_calls(arch, M, rounds, H=H_LOCAL):
    """K4b's calls in a fp32 ``train.main`` run whose M clients all take H
    local steps a round: one a routed attention application a local step
    of a client (``k4_layers``)."""
    return rounds * M * H * k4_layers(get_config(arch))


def fused_vs_tree(name, rounds=1, flips=False, H=2, cfg=None, M=4, S=128,
                  offload=False, **method_kw):
    """``rounds`` rounds at full width and 2 layers (or ``cfg``, a
    full-width config cut in depth), M clients of 8 × ``S`` (an audio or
    vlm round wrapped by ``train._wrap_modal``): fused client loop
    against the tree loop from the same start, same batches, same rng
    streams. ``offload`` keeps the fused run's final state in host memory
    while the tree loop runs (where both states and the tree loop's peak
    do not fit the card together). Every float leaf must agree to 1e-5 of
    its scale (the EF residual's and the staleness FIFO's scale is the
    matching params leaf's: u − C(u) and the averaged deltas x̄ − x_t cancel
    to ulps of the params). ``flips`` (int8 rounds): where the two loops'
    deltas differ in the last bits at an integer boundary, floor(v + u)
    flips q by one; up to 1e-4 of a leaf's elements may then differ by up
    to 2e-4 of its scale. Returns (worst relative difference, flipped
    elements, K1 launches of the fused run)."""
    cfg = cfg or get_config("qwen2-0.5b").replace(n_layers=2)
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    b = 8
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), M, b)
    root = rng.TorchStream(1)
    out = {}
    for fused in (True, False):
        spec = engine.method_spec("savic", gamma=3e-3, use_fused_kernel=fused,
                                  **method_kw)
        gen = torch.Generator(device=DEV).manual_seed(0)
        state = engine.init_state(gen, model.init, spec, M)
        step = engine.build_round_step(model.loss, spec)
        su.fused_step_flat.launches, need = 0, 0
        for r in range(rounds):
            nb = loader.round_batch(r, H, S)
            if cfg.family in ("audio", "vlm"):
                nb = train._wrap_modal(cfg, nb, 0, r)
            batch = {k: torch.from_numpy(v).to(
                DEV, torch.float32 if k in train._FLOAT_FIELDS
                else torch.long) for k, v in nb.items()}
            state, met = step(state, batch, root.fold(r))
            # one launch a local step in which any client is active
            need += max(met["ctrl_h_m"].tolist()) if "ctrl_h_m" in met \
                else max(spec.client.local_steps or (H,))
        if fused:
            k1 = su.fused_step_flat.launches
            check(k1 == need, f"{name}: K1 launched {k1} times, the "
                  f"realized H_m need {need}")
        if fused and offload:
            state = tree_map(lambda t: t.cpu(), state)
        out[fused] = (state, float(met["loss"]))
        del state, met
        torch.cuda.empty_cache()
    (sf, lf), (st, lt) = out[True], out[False]
    worst, n_flips = 0.0, 0
    tree = dict(tree_paths(st))
    for (k, a), (_, c) in zip(tree_paths(sf), tree_paths(st)):
        a = a.to(c.device)
        if not a.is_floating_point():
            check(torch.equal(a, c), f"{name}: {k} differs")
            continue
        head = k.split("/")[0]
        ref_leaf = tree["params/" + k[len(head) + 1:]] \
            if head in ("ef", "buffer") else c
        scale = float(ref_leaf.abs().max()) or 1.0
        diff = (a - c).abs()
        if flips:
            off = int((diff > 1e-5 * scale).sum())
            n_flips += off
            check(off <= max(1, int(1e-4 * diff.numel())),
                  f"{name}: {off} elements of {k} differ beyond 1e-5")
            check(float(diff.max()) <= 2e-4 * scale,
                  f"{name}: {k} differs beyond one int8 quantum")
            diff = torch.where(diff > 1e-5 * scale, 0.0, diff)
        worst = max(worst, float(diff.max()) / scale)
    del out, sf, st, tree
    torch.cuda.empty_cache()
    print(f"[chip_smoke] fused vs tree ({name}, {cfg.n_layers} layers, "
          f"M {M}, S {S}, {rounds} rounds): "
          f"loss {lf:.6f} vs {lt:.6f}, worst state diff {worst:.3e} of leaf "
          f"scale" + (f", {n_flips} int8 boundary flips" if flips else "")
          + f"; K1 launches {k1}", flush=True)
    check(abs(lf - lt) <= 1e-5 * abs(lt), f"{name}: fused and tree losses "
          f"differ")
    check(worst <= 1e-5, f"{name}: fused and tree states differ beyond 1e-5")
    return worst, n_flips, k1


def launches_for_hm(log):
    """K1 launches the logged rounds need: max_m H_m a round."""
    return sum(max(rec["ctrl_h_m"]) for rec in log)


def het_phase():
    """8a: per-client H_m from lognormal step times and a depth-2 staleness
    FIFO (polynomial weights), beside the uniform H = 4 round."""
    hm = [int(h) for h in federated.local_steps_from_times(
        federated.sample_step_times("lognormal", 4, seed=0), H_KNOBS)]
    check(len(set(hm)) > 1, f"H_m {hm} is uniform")
    argv = main_argv("savic", 2, ["--h-local", str(H_KNOBS)])
    print("[chip_smoke] 8a uniform H=4: train.main " + " ".join(argv),
          flush=True)
    ulog, _, _, upeak = main_path(argv, 2 * H_KNOBS)
    argv = main_argv("savic", 2, HET_ASYNC)
    print(f"[chip_smoke] 8a heterogeneity + async (H_m {hm}, --het-seed 0):"
          f" train.main " + " ".join(argv), flush=True)
    log, k1, _, peak = main_path(argv, 2 * max(hm))
    check(all(finite(rec["staleness"]) for rec in log), "staleness")
    check(log[1]["staleness"] > 0.0, "the FIFO's second round has no stale "
          "slot")
    print(f"[chip_smoke]   8a round wall {[r['wall_s'] for r in log]} s "
          f"(uniform H=4: {[r['wall_s'] for r in ulog]} s); launches K1 {k1} "
          f"= Σ_r max H_m; peak {peak:.2f} GiB (uniform H=4 {upeak:.2f} GiB)",
          flush=True)
    return {"hm": hm, "walls": [r["wall_s"] for r in log], "peak": peak,
            "uniform_walls": [r["wall_s"] for r in ulog],
            "uniform_peak": upeak, "k1": k1}


def controller_phase():
    """8b: the controller (H_m from the straggler trace, H_t growth, the
    EF-guarded k on topk, b_eff) at full width; the logged observations
    replayed through tests/_reference_controller.py."""
    argv = main_argv("savic", 3, CONTROLLER)
    print("[chip_smoke] 8b controller: train.main " + " ".join(argv),
          flush=True)
    log, k1, _, peak = main_path(argv, launches_for_hm)
    ctrl = train._resolve_spec(train._parser().parse_args(argv), 4)[0] \
        .controller
    s = ref_ctrl.init_ctrl_state(ctrl, 4)
    for rec in log:
        want = (s["h_m"].tolist(), int(s["h_t"]), int(s["b_eff"]),
                round(float(s["k"]), 6))
        got = (rec["ctrl_h_m"], rec["ctrl_h_t"], rec["ctrl_b_eff"],
               rec["ctrl_k"])
        check(got == want, f"round {rec['round']} knobs {got}, oracle "
              f"{want}")
        s, _ = ref_ctrl.controller_step(ctrl, s, {
            "delta_sq_mean": rec["delta_sq_mean"],
            "delta_sq_avg": rec["delta_sq_avg"],
            "payload_sq": rec["payload_sq"],
            "resid_sq": rec["compression_err"]})
        check(rec["ctrl_gns_ema"] == round(float(s["gns_ema"]), 6),
              f"round {rec['round']} gns_ema {rec['ctrl_gns_ema']}")
    print(f"[chip_smoke]   8b knobs replayed by the numpy oracle: H_m "
          f"{[r['ctrl_h_m'] for r in log]}, H_t "
          f"{[r['ctrl_h_t'] for r in log]}, k {[r['ctrl_k'] for r in log]}, "
          f"b_eff {log[0]['ctrl_b_eff']}; launches K1 {k1}; round wall "
          f"{[r['wall_s'] for r in log]} s; peak {peak:.2f} GiB", flush=True)
    return {"log": log, "k1": k1, "peak": peak,
            "walls": [r["wall_s"] for r in log]}


def topk_embed():
    """The controller's topk at the embed.table leaf (4, 137,625,600), k =
    0.1: one ``_compress_leaf`` call (the stable sort), its time and the
    memory it adds above its input."""
    x = torch.randn(EMBED, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(3))
    spec = engine.CompressionSpec(op="topk", k=0.1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: engine._compress_leaf(spec, x, None, k_frac=0.1), 3)
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    c = engine._compress_leaf(spec, x, None, k_frac=0.1)
    kc = engine._kept_count(spec, EMBED[1], 0.1)[0]
    check(bool((torch.count_nonzero(c, dim=1) == kc).all()),
          "topk kept another count")
    del x, c
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   8b topk at the embed.table leaf {EMBED}, k 0.1 "
          f"({kc} kept a row): {ms:.2f} ms a call, {extra:.2f} GiB above its "
          f"input", flush=True)
    return ms, extra


def personal_phase(rounds=2):
    """8c: local-adam with the consistency objective on half-labeled
    sequences and the final norm client-resident, through ``train.setup``
    and its round step; after each round the personal leaf differs across
    clients and every synced leaf is one value."""
    argv = main_argv("local-adam", rounds, SEMI_PERSONAL)
    print("[chip_smoke] 8c objective + personalization: train.setup + "
          "round_step " + " ".join(argv), flush=True)
    su.fused_step_flat.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.setup(argv)
    state, run.state = run.state, None
    walls = []
    for r in range(rounds):
        batch = train.round_batch(run.loader, run.args, r, DEV)
        check("labeled" in batch, "no labeled leaf")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = run.round_step(state, batch, run.stream(r))
        loss = float(met["loss"])
        walls.append(time.perf_counter() - t0)
        check(finite(loss), f"round {r} loss {loss}")
        for k, p in tree_paths(state["params"]):
            same = bool((p == p[:1]).all())
            if "final_norm" in k:
                check(not same, f"round {r}: personal {k} equal across "
                      f"clients")
            else:
                check(same, f"round {r}: synced {k} differs across clients")
        print(f"[chip_smoke]   round {r} loss {loss:.5f} wall "
              f"{walls[-1]:.4f} s; final_norm/scale differs across clients, "
              f"{len(tree_paths(state['params'])) - 1} synced leaves equal",
              flush=True)
        del batch, met
    k1 = su.fused_step_flat.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(k1 == rounds * H_LOCAL, f"K1 launched {k1} times")
    full = engine.bytes_on_wire(dataclasses.replace(
        run.spec, sync=dataclasses.replace(run.spec.sync, personal=())),
        engine.average_params(state))
    n_pers = state["params"]["final_norm"]["scale"][0].numel()
    check(run.wire["delta_bytes"] == full["delta_bytes"] - 4 * n_pers,
          f"delta bytes {run.wire['delta_bytes']} vs {full['delta_bytes']}")
    del state
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   8c delta bytes {run.wire['delta_bytes']} = "
          f"{full['delta_bytes']} − 4 × {n_pers}; launches K1 {k1}; peak "
          f"{peak:.2f} GiB", flush=True)
    return {"k1": k1, "peak": peak, "walls": walls}


# --------------------------------------------------------------------------- #
# phase 9: checkpoint and bitwise resume
# --------------------------------------------------------------------------- #

CKPT_ROOT = os.path.join(ROOT, ".chip_smoke_ckpt")   # on disk, git-ignored
MEASURED = ("wall_s", "tokens_per_s")
ARCH_2L = "qwen2-0.5b-2l"                 # full width, 2 layers (as 8d)
FIFO_INT8_PERSONAL = ["--method", "fedadam", "--compression",
                      "int8-stochastic", "--error-feedback", "--async-buffer",
                      "2", "--personalize", "final_norm"]
CTRL_TOPK_HM = ["--h-local", str(H_KNOBS), "--controller", "--async-buffer",
                "2", "--het-model", "lognormal", "--het-seed", "0",
                "--compression", "topk", "--compression-k", "0.1",
                "--error-feedback", "--ctrl-noise-target", "1e-3"]


def det(rec):
    return {k: v for k, v in rec.items() if k not in MEASURED}


def sha256_file(path, chunk=1 << 26, window=8):
    """sha256 of the sha256 digests of the file's 64 MiB chunks: equal
    files give equal digests and a difference anywhere changes its chunk's.
    ``window`` chunks are read, then hashed on as many threads (hashlib
    frees the GIL), so the host's cores share the hashing and at most
    ``window`` chunks are held."""
    h = hashlib.sha256()
    digest = lambda block: hashlib.sha256(block).digest()
    with open(path, "rb") as f, ThreadPoolExecutor(window) as pool:
        while True:
            blocks = [b for b in (f.read(chunk) for _ in range(window)) if b]
            if not blocks:
                return h.hexdigest()
            for d in pool.map(digest, blocks):
                h.update(d)


def step_files(d, step):
    """(sha256 of data.bin, state.msgpack's bytes, data.bin's size)."""
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        manifest = f.read()
    data = os.path.join(path, "data.bin")
    return sha256_file(data), manifest, os.path.getsize(data)


def rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class CkptIO:
    """Times every ``checkpoint.save`` and ``checkpoint.restore`` that
    ``train.main`` makes while it is entered (it swaps the package's two
    functions and puts them back on exit), and samples the host's resident
    memory every 2 ms during a restore, beside ``getrusage``'s peak of the
    process so far."""

    def __init__(self, save_peaks=False):
        # save_peaks: read the device peak before each save and during it
        # (this resets the peak counter, so a caller that reads the run's
        # own peak afterwards must leave it off)
        self.saves, self.restores = [], []
        self.save_peaks = save_peaks

    def __enter__(self):
        self._save, self._restore = ckpt_lib.save, ckpt_lib.restore

        def save(d, step, state, keep=3, **kw):
            rec = {"step": step}
            if self.save_peaks:
                # the device peak so far (the rounds'), then the save's own
                rec["peak_rounds"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            path = self._save(d, step, state, keep, **kw)
            rec["s"] = time.perf_counter() - t0
            rec["bytes"] = os.path.getsize(os.path.join(path, "data.bin"))
            if self.save_peaks:
                rec["peak_save"] = torch.cuda.max_memory_allocated()
            self.saves.append(rec)
            return path

        def restore(d, template, step=None, **kw):
            before = rss_bytes()
            peak, done = [before], threading.Event()

            def sample():
                while not done.wait(0.002):
                    peak[0] = max(peak[0], rss_bytes())
            th = threading.Thread(target=sample)
            th.start()
            t0 = time.perf_counter()
            try:
                out = self._restore(d, template, step, **kw)
                torch.cuda.synchronize()
            finally:
                done.set()
                th.join()
            sec = time.perf_counter() - t0
            peak[0] = max(peak[0], rss_bytes())
            self.restores.append({
                "step": out[1], "s": sec, "rss_before": before,
                "rss_peak_sampled": peak[0],
                "ru_maxrss": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024,
                "bytes": os.path.getsize(os.path.join(
                    d, f"step_{out[1]:08d}", "data.bin"))})
            return out

        ckpt_lib.save, ckpt_lib.restore = save, restore
        return self

    def __exit__(self, *exc):
        ckpt_lib.save, ckpt_lib.restore = self._save, self._restore
        return False


class Tee:
    """stdout for a run: printed as usual and kept for checking."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def io_line(io):
    out = []
    for s in io.saves:
        peaks = (f"; device peak {s['peak_save'] / 2 ** 30:.2f} GiB during "
                 f"it, {s['peak_rounds'] / 2 ** 30:.2f} GiB before"
                 if "peak_save" in s else "")
        out.append(f"save step {s['step']} {s['bytes']} B in {s['s']:.2f} s "
                   f"({s['bytes'] / s['s'] / 1e9:.2f} GB/s{peaks})")
    for r in io.restores:
        out.append(f"restore step {r['step']} {r['bytes']} B in "
                   f"{r['s']:.2f} s ({r['bytes'] / r['s'] / 1e9:.2f} GB/s); "
                   f"host RSS {r['rss_before'] / 2 ** 30:.2f} GiB before, "
                   f"peak {r['rss_peak_sampled'] / 2 ** 30:.2f} GiB sampled"
                   f", ru_maxrss {r['ru_maxrss'] / 2 ** 30:.2f} GiB (the "
                   f"process's peak so far)")
    return "; ".join(out)


def resume_case(label, argv, t, T, d, expect_k1, expect_k3=0):
    """train(T) against train(t) + restore + train(T − t) through
    ``train.main`` with ``--ckpt``: the resumed run prints the restore and
    logs only rounds t..T-1, equal in every deterministic field; the final
    checkpoints are byte for byte equal (data.bin by sha256, as the first
    run's is deleted before the second writes). ``expect_k1(rounds, log)``
    gives the K1 launches a run needs. Returns what it measured."""
    da, db = os.path.join(d, "a"), os.path.join(d, "b")
    t0 = time.perf_counter()
    with CkptIO() as io_a:
        log_a, k1_a, k3_a, peak_a = main_path(
            argv + ["--rounds", str(T), "--ckpt", da, "--ckpt-every",
                    str(T)], expect_k1, expect_k3 * T)
    th = time.perf_counter()
    sha_a, man_a, size = step_files(da, T)
    hash_s = time.perf_counter() - th
    shutil.rmtree(da)
    with CkptIO() as io_b:
        log_b1, k1_b1, k3_b1, _ = main_path(
            argv + ["--rounds", str(t), "--ckpt", db, "--ckpt-every",
                    str(t)], expect_k1, expect_k3 * t)
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            log_b2, k1_b2, k3_b2, peak_b = main_path(
                argv + ["--rounds", str(T), "--ckpt", db, "--ckpt-every",
                        str(t)], expect_k1, expect_k3 * (T - t))
    check(any(s.startswith(f"[train] restored round {t} ")
              for s in "".join(tee.text).splitlines()),
          f"{label}: the resumed run printed no restore of round {t}")
    check([r["round"] for r in log_b1] == list(range(t)), f"{label}: first "
          f"half logged rounds {[r['round'] for r in log_b1]}")
    check([r["round"] for r in log_b2] == list(range(t, T)),
          f"{label}: resumed run logged rounds "
          f"{[r['round'] for r in log_b2]}")
    for ra, rb in zip(log_a, log_b1 + log_b2):
        check(det(ra) == det(rb), f"{label}: round {ra['round']} differs "
              f"after the restore: {det(ra)} vs {det(rb)}")
    # the restore frees the initial state first and shares the replicated
    # leaves again, so the resumed run needs no more memory than the first
    check(peak_b <= peak_a, f"{label}: the resumed run peaks at "
          f"{peak_b:.2f} GiB, the uninterrupted one at {peak_a:.2f}")
    sha_b, man_b, _ = step_files(db, T)
    check(man_a == man_b, f"{label}: state.msgpack differs")
    check(sha_a == sha_b, f"{label}: data.bin differs ({sha_a} vs {sha_b})")
    shutil.rmtree(db)
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   {label}: {T} rounds straight vs {t} + restore + "
          f"{T - t}: rounds {list(range(t, T))} equal in every "
          f"deterministic field, step {T} data.bin sha256 {sha_a[:16]}… "
          f"equal ({size} B), state.msgpack equal ({len(man_a)} B); K1 "
          f"{k1_a} vs {k1_b1} + {k1_b2}, K3 {k3_a} vs {k3_b1} + {k3_b2}; "
          f"peak {peak_a:.2f} GiB vs {peak_b:.2f} GiB resumed; "
          f"straight: {io_line(io_a)}; split: {io_line(io_b)}; sha256 of "
          f"one data.bin {hash_s:.2f} s; case {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return {"size": size, "io_a": io_a, "io_b": io_b, "k1": (k1_a, k1_b1,
                                                               k1_b2),
            "k3": (k3_a, k3_b1, k3_b2), "peak": (peak_a, peak_b),
            "walls": [r["wall_s"] for r in log_a]}


def resume_phase(shapes):
    """9a: savic through K1 at full width cut to 2 layers, M = 4, 3 rounds
    straight against 2 + restore + 1 (the 24-layer model's 17.84 GB saves
    took 125 s of the script's time on the machine's 9p disk; 2 layers
    keep K1 on the (4, n) buffer and every leaf kind at full width, at a
    third of the bytes); 9b: two 2-layer cases, 4 rounds against 2 + 2.
    ``shapes`` is full-width qwen2-0.5b's {path: shape}."""
    register_cut("qwen2-0.5b", 2)
    n = tree_n(get_config(ARCH_2L))
    os.makedirs(CKPT_ROOT, exist_ok=True)
    usage = shutil.disk_usage(CKPT_ROOT)
    fs = subprocess.run(["df", "-hT", CKPT_ROOT], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    M = 4
    need = 2 * (2 * M + 1) * n * 4
    print(f"[chip_smoke] 9a checkpoint dir {CKPT_ROOT}: {usage.free} B free "
          f"of {usage.total} ({fs}); two savic checkpoints at M = {M}, "
          f"n = {n} need {need} B", flush=True)
    check(usage.free > need + (1 << 30), f"{usage.free} B free: too few "
          f"for two M = {M} checkpoints")
    argv = ["--arch", ARCH_2L, "--method", "savic", "--use-fused-kernel",
            "--rounds", "3", "--h-local", str(H_LOCAL), "--clients", str(M),
            "--batch", "8", "--seq", "128", "--device", "cuda"]
    print("[chip_smoke] 9a resume, full width, 2 layers: train.main "
          + " ".join(argv) + " --ckpt ...", flush=True)
    a = resume_case("9a savic", argv, 2, 3, os.path.join(CKPT_ROOT, "9a"),
                    lambda log: len(log) * H_LOCAL)
    # params and momentum (M, n) each, global D (n), fp32; then the int32
    # scalars (the round, D's step count)
    expect = 4 * (2 * M + 1) * n
    check(0 <= a["size"] - expect <= 64, f"9a data.bin {a['size']} B, "
          f"expected (2M + 1)·n·4 = {expect} + a few scalars")
    print(f"[chip_smoke]   9a data.bin {a['size']} B = (2M + 1)·n·4 + "
          f"{a['size'] - expect} B of scalars", flush=True)
    n_synced = sum("final_norm" not in p for p in shapes)  # K3 a round
    b = []
    for label, flags, k1, k3 in (
            ("9b fedadam int8 + EF + FIFO 2 + personal final_norm",
             FIFO_INT8_PERSONAL, lambda log: len(log) * H_LOCAL, n_synced),
            ("9b savic controller + topk 0.1 + EF + lognormal H_m",
             CTRL_TOPK_HM, launches_for_hm, 0)):
        argv = ["--arch", ARCH_2L, "--use-fused-kernel", "--h-local",
                str(H_LOCAL), "--clients", "4", "--batch", "8", "--seq",
                "128", "--device", "cuda"] + flags
        print(f"[chip_smoke] {label}: train.main " + " ".join(argv)
              + " --ckpt ...", flush=True)
        b.append(resume_case(label, argv, 2, 4,
                             os.path.join(CKPT_ROOT, "9b"), k1, k3))
    return {"M": M, "n": n, "free": usage.free, "a": a, "b": b}


def train_lm_phase():
    """9c: launch/train_lm.py's six methods at the bench's point (reduced
    qwen2-0.5b, M = 4, H = 8, b = 4, S = 64, 10 rounds), then savic at
    full width for 2 rounds; K1 counted over each."""
    F_ = train_lm.FIXED
    t0 = time.perf_counter()
    su.fused_step_flat.launches = 0
    rows = [train_lm.run_method(m, device="cuda")
            for m in train_lm.TRAIN_LM_OVERRIDES]
    k1 = su.fused_step_flat.launches
    check(k1 == len(rows) * F_["rounds"] * F_["h_local"], f"9c K1 {k1}")
    su.fused_step_flat.launches = 0
    full = train_lm.run_method("savic", device="cuda", full=True, rounds=2)
    k1_full = su.fused_step_flat.launches
    check(k1_full == 2 * F_["h_local"], f"9c full-width K1 {k1_full}")
    for r in rows + [full]:
        check(all(finite(v) for v in r["info"]["loss_curve"]),
              f"9c {r['coords']} non-finite loss {r['info']['loss_curve']}")
        print("[chip_smoke]   9c " + json.dumps(r), flush=True)
    print(f"[chip_smoke]   9c summary (reduced) "
          f"{json.dumps(dict(train_lm.summary(rows)))}; full-width savic "
          f"{json.dumps(dict(train_lm.summary([full])))}; K1 {k1} (reduced, "
          f"{len(rows)} × {F_['rounds']} × {F_['h_local']}), {k1_full} (full "
          f"width); {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "full": full, "k1": k1, "k1_full": k1_full}


# --------------------------------------------------------------------------- #
# phase 17: training of the families served only, at full width
# --------------------------------------------------------------------------- #

# savic's measured device bytes a parameter: 35.0 at M = 1 (the 1x1 fused
# run, 16.15 GiB at n = 495,523,712) plus 15.9 for each further client
# (qwen2-0.5b at M = 4: 38.17 GiB)
SAVIC_B, CLIENT_B = 35.0, 15.9
P17_M = 2
# label, arch, layers (None: full depth), seq; the cuts keep the predicted
# peak at M = 2 within 60 GiB (gemma3's 6 layers hold its first global
# layer, index 5; qwen2-moe's layer 0 is an MoE layer)
P17_RUNS = (("17a", "mamba2-1.3b", 36, 128),
            ("17b", MOE_ARCH, 1, 128),
            ("17c", "gemma3-4b", 6, 128),
            ("17d", "musicgen-large", 16, 128),
            ("17e", "internvl2-1b", None, 384),   # 256 patches + 128 tokens
            ("17i", "nemotron3-nano-30b-a3b-ep16", 13, 128))
# fused against tree at a smaller depth (gemma3: at S 128 its 1024 window
# masks nothing, so a global layer adds nothing there)
P17_PAIRS = (("mamba2-1.3b", 4, 128), (MOE_ARCH, 1, 128),
             ("gemma3-4b", 2, 128), ("musicgen-large", 4, 128),
             ("internvl2-1b", 4, 384))
P17_INT8_LAYERS = 24          # mamba2 with int8 + EF: +2 (M, n) EF buffers
NEMO_17I = "nemotron3-nano-30b-a3b-ep16 13-layer"


def predicted_gib(n, M=P17_M, extra_b=0.0):
    """The savic round's peak predicted from the measured bytes a
    parameter (``SAVIC_B``, ``CLIENT_B``), plus ``extra_b`` a parameter."""
    return (SAVIC_B + CLIENT_B * (M - 1) + extra_b) * n / 2 ** 30


def p17_argv(arch, seq, extra=()):
    return ["--arch", arch, "--method", "savic", "--use-fused-kernel",
            "--rounds", "2", "--h-local", str(H_LOCAL), "--clients",
            str(P17_M), "--batch", "8", "--seq", str(seq), "--device",
            "cuda", *extra]


def modal_draw_s(cfg, seq, rounds=2):
    """Host seconds of ``train._wrap_modal`` (the reference's numpy draws)
    on each round's token batch at this run's shape, and the batch's
    embedding bytes."""
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), P17_M, 8,
                           seed=0)
    out, nb_bytes = [], 0
    for r in range(rounds):
        nb = loader.round_batch(r, H_LOCAL, seq)
        t0 = time.perf_counter()
        w = train._wrap_modal(cfg, nb, 0, r)
        out.append(round(time.perf_counter() - t0, 4))
        nb_bytes = sum(w[k].nbytes for k in ("embeds", "patches") if k in w)
    return out, nb_bytes


def train_family(label, arch, layers, seq, extra=(), expect_k3=0,
                 extra_b=0.0):
    """One ``train.main`` run of phase 17 (M = 2, H = 2, b = 8, 2 rounds,
    fp32, seed 0) on the fused loop: K1 launched once a local step, every
    record finite with loss > 0 and drift > 0; an SSM's SSD on the card's
    training route, K7b once a layer a local step of a client and K7 twice
    (forward and remat recompute), over a pattern stack's Mamba-2 layers
    (nemotron_h's 8 groups reach K7 as per-head copies), other families on
    neither; attention on K4 + K4b alike (``k4b_calls``: none on gemma3's
    D 256 or an SSM); prints n, M·n, the peak beside the prediction, each
    round's wall and tokens/s and the K4, K4b, K7 and K7b counts of the
    run."""
    name = register_cut(arch, layers)
    cfg = get_config(name)
    n = tree_n(cfg)
    pred = predicted_gib(n, extra_b=extra_b)
    argv = p17_argv(name, seq, extra)
    past = " > 2^31" if P17_M * n > 2 ** 31 else ""
    print(f"[chip_smoke] {label} {arch} training, full width, "
          f"{cfg.n_layers} of {get_config(arch).n_layers} layers (n = {n} "
          f"in the tree; M·n = {P17_M * n}{past}; predicted peak "
          f"{pred:.2f} GiB): train.main " + " ".join(argv), flush=True)
    t0 = time.perf_counter()
    log, k1, k3, peak = main_path(argv, 2 * H_LOCAL, expect_k3,
                                  k4b_calls(name, P17_M, 2))
    k7, k7b = ssd.ssd_intra_chunk.launches, ssd.ssd_intra_chunk_bwd.launches
    k4, k4b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    mamba = cfg.n_layers if cfg.family == "ssm" \
        else cfg.layer_kinds.count("M")
    calls = P17_M * H_LOCAL * mamba * 2
    check(k7b == calls and k7 == 2 * calls, f"{label}: K7 {k7}, K7b {k7b} "
          f"launched; expected {2 * calls} and {calls}")
    for rec in log:
        check(rec["loss"] > 0 and rec["drift"] > 0, f"{label}: round "
              f"{rec['round']} loss {rec['loss']} drift {rec['drift']}")
    out = {"arch": arch, "layers": cfg.n_layers, "n": n, "mn": P17_M * n,
           "k1": k1, "k3": k3, "k7": k7, "k7b": k7b, "k4": k4, "k4b": k4b,
           "peak": peak, "pred": pred,
           "walls": [r["wall_s"] for r in log],
           "tokens_per_s": [r["tokens_per_s"] for r in log],
           "losses": [r["loss"] for r in log],
           "drifts": [r["drift"] for r in log]}
    if cfg.family in ("audio", "vlm"):
        out["draw_s"], out["draw_bytes"] = modal_draw_s(cfg, seq)
    out["secs"] = time.perf_counter() - t0
    print(f"[chip_smoke]   {label}: peak {peak:.2f} GiB, predicted "
          f"{pred:.2f} GiB (ratio {peak / pred:.3f}); walls {out['walls']} "
          f"s, tokens/s {out['tokens_per_s']}; K1 {k1}, K3 {k3}, K4 {k4}, "
          f"K4b {k4b}, K7 {k7}, K7b {k7b}"
          + (f"; modal draws {out['draw_s']} s a round "
             f"({out['draw_bytes']} B of fp32 embeddings)"
             if "draw_s" in out else "")
          + f"; {out['secs']:.1f} s", flush=True)
    return out


def bf16_family(label, arch, layers, seq):
    """17h: ``--dtype bfloat16`` with ``--use-fused-kernel``. The flag sets
    the compute dtype; the params, momentum and D stay fp32 masters (as the
    reference's ``param_dtype``), so ``engine.fused_route`` keeps the fused
    loop: K1 once a local step and no ``fused_kernel_fallback`` line
    (the fallback needs non-fp32 client state, which no ``train.main`` flag
    makes; the CPU tests hold it)."""
    name = register_cut(arch, layers)
    argv = p17_argv(name, seq, ["--dtype", "bfloat16"])
    print(f"[chip_smoke] {label} {arch} bf16 compute, {layers} layer(s): "
          f"train.main " + " ".join(argv), flush=True)
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        log, k1, k3, peak = main_path(argv, 2 * H_LOCAL, expect_k4b=0)
    lines = [ln for ln in "".join(tee.text).splitlines()
             if ln.startswith("[train] tree loop: ")]
    check(not lines, f"{label}: fp32 state took the tree loop: {lines}")
    for rec in log:
        check(rec["loss"] > 0 and rec["drift"] > 0, f"{label}: round "
              f"{rec['round']} loss {rec['loss']} drift {rec['drift']}")
    return {"k1": k1, "peak": peak, "walls": [r["wall_s"] for r in log],
            "losses": [r["loss"] for r in log]}


def phase17():
    """Phase 17: ``train.main`` at full width for the families served only
    (17a-17e), fused against tree for each at a smaller depth (17f), int8
    + EF on mamba2 (17g, K3 once a leaf a round), bf16 compute on
    qwen2-moe (17h, fp32 state on K1)."""
    t0 = time.perf_counter()
    runs = {label: train_family(label, arch, layers, seq)
            for label, arch, layers, seq in P17_RUNS}
    pairs = {}
    for arch, layers, seq in P17_PAIRS:
        cfg = get_config(arch).replace(n_layers=layers)
        worst, _, k1 = fused_vs_tree(f"17f {arch} savic", cfg=cfg, M=P17_M,
                                     S=seq, offload=True)
        pairs[arch] = {"worst": worst, "k1": k1, "layers": layers}
    with FakeTensorMode():
        n_leaves = len(tree_paths(build_model(get_config(
            "mamba2-1.3b")).init(torch.Generator())))
    g = train_family("17g", "mamba2-1.3b", P17_INT8_LAYERS, 128, INT8_EF,
                     expect_k3=2 * n_leaves, extra_b=2 * 4 * P17_M)
    h = bf16_family("17h", MOE_ARCH, 1, 128)
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] phase 17: {secs:.1f} s; peaks / predicted "
          + ", ".join(f"{k} {r['peak']:.2f} / {r['pred']:.2f} GiB"
                      for k, r in {**runs, "17g": g}.items())
          + f"; 17h bf16 compute {h['peak']:.2f} GiB (17b fp32 "
          f"{runs['17b']['peak']:.2f}); 17f worst "
          + ", ".join(f"{a} {p['worst']:.3e}" for a, p in pairs.items())
          + f"; K1 {[r['k1'] for r in runs.values()]} + 17g {g['k1']}, K3 "
          f"17g {g['k3']} ({n_leaves} leaves × 2 rounds), 17h K1 "
          f"{h['k1']}; K7 / K7b 17a {runs['17a']['k7']} / "
          f"{runs['17a']['k7b']}, 17g {g['k7']} / {g['k7b']}", flush=True)
    return {"runs": runs, "pairs": pairs, "g": g, "h": h, "secs": secs}


def ptxas_summary(log):
    """One line per kernel of a ``-Xptxas -v`` log: its (mangled) name,
    registers, spill stores and loads, shared memory."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


class Laps:
    """Seconds of each phase of ``main``, each printed on its own line."""

    def __init__(self):
        self.t, self.secs = time.perf_counter(), {}

    def __call__(self, label):
        now = time.perf_counter()
        self.secs[label] = round(now - self.t, 1)
        self.t = now
        print(f"[chip_smoke] phase {label}: {self.secs[label]:.1f} s",
              flush=True)


def build_all():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    libs = (su._lib, su._flat_lib, qu._lib, ds._attention_lib,
            ds._sample_lib, fa._lib, fa._lib_bwd, ssd._lib, ssd._lib_bwd)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        list(pool.map(lambda f: f(), libs))
    for src in ("fused_step.cu", "scaled_update.cu", "quantize_update.cu",
                "decode_attention.cu", "decode_sample.cu",
                "flash_attention.cu", "flash_attention_bwd.cu",
                "ssd_intra_chunk.cu", "ssd_intra_chunk_bwd.cu"):
        info = build.BUILD_LOG.get(src, {"seconds": 0.0, "ptxas": "(cached)"})
        print(f"[chip_smoke] {src}: nvcc {info['seconds']:.2f} s\n"
              f"{info['ptxas']}", flush=True)
    for src in ("decode_attention.cu", "flash_attention.cu",
                "flash_attention_bwd.cu", "ssd_intra_chunk.cu",
                "ssd_intra_chunk_bwd.cu"):
        for line in ptxas_summary(build.BUILD_LOG.get(src, {}).get("ptxas",
                                                                  "")):
            print(f"[chip_smoke] ptxas {src}: {line}", flush=True)
    print(f"[chip_smoke] built K1, K2, K3, K4, K4b, K5, K6, K7 and K7b in "
          f"{time.perf_counter() - t0:.2f} s",
          flush=True)


def main():
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] {smi_line()} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(0)

    lap = Laps()
    # ---- 1. build ----------------------------------------------------------
    build_all()
    lap("1 build")

    # ---- 2. K1 against its plain version, every engine combination --------
    max_err = 0.0
    for case in K1_CASES:
        for n in (K1_N, K1_N + 1, K1_N - 1):
            err, ulps = compare_case(case, 4, n, gen)
            max_err = max(max_err, err)
            print(f"[chip_smoke] K1 {'-'.join(map(str, case))} n={n}: "
                  f"max abs {err:.3e}, max ulp {ulps}", flush=True)
            check(ulps == 0, f"K1 differs from its plain version ({case})")
    M, n, err, ulps = big_case(gen)
    max_err = max(max_err, err)
    print(f"[chip_smoke] K1 M={M} n={n} (M·n = {M * n} > 2^31): max abs "
          f"{err:.3e}, max ulp {ulps}", flush=True)
    check(ulps == 0, "K1 differs from its plain version beyond 2^31")

    # ---- 2b. K3 against its plain version ----------------------------------
    k3_err = 0.0
    k3_cases = [(M, n, (), False) for M in (1, 4)
                for n in (K1_N, K1_N + 1, K1_N - 1)]
    k3_cases += [(4, K1_N, (0, 2), False), (4, K1_N + 1, (3,), False),
                 (4, K1_N, (), True), (3, K1_N - 1, (1,), True)]
    for M, n, zero_rows, misalign in k3_cases:
        bad, err, ulps = k3_case(M, n, gen, zero_rows, misalign)
        k3_err = max(k3_err, err)
        print(f"[chip_smoke] K3 M={M} n={n} zero rows {list(zero_rows)}"
              f"{' misaligned' if misalign else ''}: q mismatches {bad}, "
              f"dec max abs {err:.3e}, max ulp {ulps}", flush=True)
        check(bad == 0 and ulps == 0, "K3 differs from its plain version")
    for M, n in K3_BIG:
        bad, err, ulps = k3_big(M, n, gen)
        k3_err = max(k3_err, err)
        print(f"[chip_smoke] K3 M={M} n={n} (M·n = {M * n} > 2^31): q "
              f"mismatches {bad}, dec max abs {err:.3e}, max ulp {ulps}",
              flush=True)
        check(bad == 0 and ulps == 0, "K3 differs beyond 2^31")
    (bad, err, ulps), k3_ms, k3_plain_ms, k3_nbytes = k3_embed(gen)
    k3_err = max(k3_err, err)
    k3_bound_ms = k3_nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[chip_smoke] K3 at the embed.table leaf {EMBED}: q mismatches "
          f"{bad}, dec max ulp {ulps}; {k3_ms:.3f} ms/launch, plain "
          f"{k3_plain_ms:.3f} ms, bound {k3_bound_ms:.3f} ms "
          f"({k3_nbytes / 1e9:.3f} GB), achieved "
          f"{k3_nbytes / k3_ms / 1e6:.1f} GB/s", flush=True)
    check(bad == 0 and ulps == 0, "K3 differs at the embed.table shape")

    # ---- 2c. K2 against its plain version ----------------------------------
    k2_err = 0.0
    for n in K2_NS:
        worst = (0.0, 0)
        for squared in (True, False):
            for beta1 in (0.0, 0.9):
                for alpha in (1e-3, 1e-2):
                    err, ulps = k2_case(n, squared, beta1, alpha, gen)
                    worst = (max(worst[0], err), max(worst[1], ulps))
        k2_err = max(k2_err, worst[0])
        print(f"[chip_smoke] K2 n={n}, squared both ways, beta1 0 / 0.9, "
              f"alpha 1e-3 / 1e-2: max abs {worst[0]:.3e}, max ulp "
              f"{worst[1]}", flush=True)
        check(worst[1] == 0, f"K2 differs from its plain version at n={n}")
    x = k2_inputs(K2_NS[-2], gen)
    k2_1m = cuda_ms(lambda: su.scaled_update_flat(*x, **K2_STEP), 200)
    del x
    print(f"[chip_smoke] K2 at n={K2_NS[-2]}: {k2_1m * 1e3:.2f} us/launch, "
          f"bound {24 * K2_NS[-2] / HBM_BYTES_PER_S * 1e6:.2f} us "
          f"({24 * K2_NS[-2]} B)", flush=True)
    for n in (K2_NS[-2], K2_NS[-1]):
        err, ulps = k2_case(n, True, 0.9, 1e-2, gen, misalign=True)
        k2_err = max(k2_err, err)
        print(f"[chip_smoke] K2 n={n} misaligned views (scalar path): max abs"
              f" {err:.3e}, max ulp {ulps}", flush=True)
        check(ulps == 0, "K2 differs from its plain version on misaligned "
              "views")
    for misalign in (False, True):
        n, err, ulps = k2_big(gen, misalign)
        k2_err = max(k2_err, err)
        print(f"[chip_smoke] K2 n={n} (> 2^31, "
              f"{'views one float in, scalar path' if misalign else 'aligned, float4 path with a masked tail'}"
              f"): max abs {err:.3e}, max ulp {ulps} over every element",
              flush=True)
        check(ulps == 0, "K2 differs from its plain version beyond 2^31")

    lap("2 K1, K3, K2 against their plain versions")

    # ---- 3. main path: savic, full-width qwen2-0.5b ------------------------
    argv = main_argv("savic", 2)
    print("[chip_smoke] main path: train.main " + " ".join(argv), flush=True)
    log, launches, _, peak = main_path(
        argv, 2 * H_LOCAL, expect_k4b=k4b_calls("qwen2-0.5b", 4, 2))
    main_k4 = fa.flash_attention.launches
    main_k4b = fa.flash_attention_bwd.launches

    params = build_model(get_config("qwen2-0.5b")).init(
        torch.Generator(device=DEV).manual_seed(0))
    n_main = tree_size(params)          # per-client flat length n
    qwen_shapes = {k: tuple(v.shape) for k, v in tree_paths(params)}
    wire = engine.bytes_on_wire(engine.method_spec(
        "savic", compression="int8-stochastic", error_feedback=True), params)
    del params
    torch.cuda.empty_cache()
    main_case = ("adam", "debias", "max", "global", False, 0.0, False, False)
    err, ulps, ms, plain_ms, nbytes = k1_main_shape(main_case, 4, n_main,
                                                    gen, plain_timing=True)
    max_err = max(max_err, err)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[chip_smoke] K1 at the main path's shape (M=4, n={n_main}, "
          f"global D): max abs {err:.3e}, max ulp {ulps}; {ms:.3f} ms/launch, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.2f} GB), achieved {nbytes / ms / 1e6:.1f} GB/s",
          flush=True)
    check(ulps == 0, "K1 differs from its plain version at the main shape")

    # ---- 3b. K2 on its path: the per-leaf step ------------------------------
    k2_runs = [k2_path("the Fig. 1 MLP", *MLP_TREE, gen),
               k2_path("the kernels_fused bench's leaves", *BENCH_TREE, gen),
               k2_path("full-width qwen2-0.5b", qwen_shapes, 4, gen)]
    for r in k2_runs:
        print_k2_path(r)
    k2_launches = sum(r["launches"] for r in k2_runs)
    k2_full = k2_runs[-1]
    check(k2_full["n"] == n_main, "the qwen2 tree is not the model's")

    # ---- 4. local-adam: update_d + debias ---------------------------------
    argv = main_argv("local-adam", 1)
    print("[chip_smoke] train.main " + " ".join(argv), flush=True)
    main_path(argv, H_LOCAL, expect_k4b=k4b_calls("qwen2-0.5b", 4, 1))
    la_case = ("adam", "debias", "max", "local", True, 0.0, False, False)
    err, ulps, la_ms, _, la_bytes = k1_main_shape(la_case, 4, n_main, gen,
                                                  plain_timing=False)
    max_err = max(max_err, err)
    print(f"[chip_smoke] K1 local D with update (M=4, n={n_main}): max abs "
          f"{err:.3e}, max ulp {ulps}; {la_ms:.3f} ms/launch, bound "
          f"{la_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, achieved "
          f"{la_bytes / la_ms / 1e6:.1f} GB/s", flush=True)
    check(ulps == 0, "K1 differs from its plain version at the main shape "
          "with local D")

    # ---- 5. compressed path: savic + int8-stochastic + EF -----------------
    argv = main_argv("savic", 2, INT8_EF)
    print("[chip_smoke] compressed path: train.main " + " ".join(argv),
          flush=True)
    clog, _, k3_launches, cpeak = main_path(
        argv, 2 * H_LOCAL, 2 * N_LEAVES, k4b_calls("qwen2-0.5b", 4, 2))
    for rec in clog:
        check(finite(rec["compression_err"]) and rec["compression_err"] > 0,
              f"compression_err {rec['compression_err']}")
        check(rec["compression_x"] == wire["compression_x"]
              and rec["delta_bytes"] == wire["delta_bytes"],
              f"records {rec['compression_x']}x / {rec['delta_bytes']} B, "
              f"bytes_on_wire {wire['compression_x']}x / "
              f"{wire['delta_bytes']} B")
        check(rec["wire_bytes"] == [wire["delta_bytes"]] * 4,
              f"measured payload {rec['wire_bytes']} != "
              f"{wire['delta_bytes']} per client")
    print(f"[chip_smoke]   payload {wire['delta_bytes']} B per client "
          f"({wire['compression_x']}x), measured == analytic", flush=True)

    # ---- 6. randomized path: savic + OASIS + participation 0.5 -------------
    argv = main_argv("savic", 2, OASIS_HALF)
    print("[chip_smoke] randomized path: train.main " + " ".join(argv),
          flush=True)
    _, _, _, rpeak = main_path(argv, 2 * H_LOCAL)
    root = rng.TorchStream(0 + 1)              # train.main's --seed 0
    for r in range(2):
        w = engine.participation_weights(engine.SyncSpec(participation=0.5),
                                          root.fold(r), 4, DEV)
        check(sorted(w.tolist()) == [0.0, 0.0, 0.5, 0.5],
              f"round {r} sync weights {w.tolist()}")
        print(f"[chip_smoke]   round {r} sync weights {w.tolist()}",
              flush=True)

    lap("3-6 the qwen2-0.5b training paths")

    # ---- 7. fused against tree at full width, 2 layers ---------------------
    fused_vs_tree("savic")
    fused_vs_tree("savic int8 + EF", rounds=2, flips=True,
                  compression="int8-stochastic", error_feedback=True)
    fused_vs_tree("savic local OASIS", pc_kind="oasis", scaling="local")

    # ---- 8a-8d. the round's knobs at full width, H = 4 ---------------------
    het = het_phase()
    ctl = controller_phase()
    topk_ms, topk_gib = topk_embed()
    pers = personal_phase()
    _, _, k1_8d_hm = fused_vs_tree(
        "savic H_m (4, 3, 2, 1) + async 2", rounds=2, H=H_KNOBS,
        local_steps=(4, 3, 2, 1), async_buffer=2,
        staleness_weight="polynomial")
    # randk: its kept set comes from the stream, not from the deltas, so no
    # rank at the selection's edge can differ between the two loops
    _, _, k1_8d_ctrl = fused_vs_tree(
        "savic controller + randk EF + async 2", rounds=3, H=H_KNOBS,
        async_buffer=2, compression="randk", compression_k=0.1,
        error_feedback=True, controller=engine.ControllerSpec(
            enabled=True, h_max=H_KNOBS, noise_target=1e-3, buffer_max=2,
            step_times=tuple(federated.sample_step_times("lognormal", 4,
                                                         seed=0))))

    lap("7-8d fused vs tree and the round's knobs")

    # ---- 7b. the paper's experiments: fig1, thm1 transient, sec52 ---------
    paper_phase()
    lap("7b the paper's experiments")

    # ---- 8. K5 and K6 against their plain versions ------------------------
    k5_err = 0.0
    B, C, Hk, rep, D = K5_MAIN
    k5_cases = [(B, C_, Hk, rep, D, cap, False)
                for C_ in (C, 1, 31, 127, 128, 129, 8192, 32768)
                for cap in (0.0, 30.0)]
    k5_cases += [(*K5_LONG[:4], D, cap, False) for cap in (0.0, 30.0)]
    k5_cases += [(B, C, Hk, rep, D, 0.0, True), (B, 8192, Hk, rep, D, 30.0,
                                                 True),
                 (1, 4099, 1, rep, D, 0.0, False),     # B·Hk = 1
                 (1, 32768, 1, rep, D, 30.0, True),
                 (2, 8224, Hk, rep, 36, 0.0, False),   # scalar loads
                 (2, 300, Hk, 16, D, 30.0, False)]     # rep = RMAX
    for B_, C_, Hk_, rep_, D_, cap, one in k5_cases:
        err, bound = k5_case(B_, C_, Hk_, rep_, D_, cap, gen, one)
        k5_err = max(k5_err, err)
        print(f"[chip_smoke] K5 B={B_} C={C_} Hk={Hk_} rep={rep_} D={D_} "
              f"softcap={cap} plan {ds.attention_plan(B_, Hk_, C_)}"
              f"{' all but one masked' if one else ''}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, "K5 differs from its plain version")
    # one valid position, at the start, middle and end of every split (all
    # other splits wholly masked), at both path shapes and around whole
    # splits (C one short and one past)
    for B_, C_, Hk_ in ((B, C, Hk), (*K5_LONG[:2], Hk), (B, 3 * 64 - 1, Hk),
                        (B, 3 * 64 + 1, Hk)):
        split, splits = ds.attention_plan(B_, Hk_, C_)
        worst, least = 0.0, float("inf")     # largest error, smallest bound
        for sp in range(splits):
            for at in sorted({sp * split, min(C_ - 1, sp * split + split // 2),
                              min(C_ - 1, (sp + 1) * split - 1)}):
                err, bound = k5_case(B_, C_, Hk_, rep, D, 30.0 * (sp % 2),
                                     gen, at=at)
                check(err <= bound, f"K5 differs from its plain version with "
                      f"one valid position at {at} (C={C_})")
                worst, least = max(worst, err), min(least, bound)
        k5_err = max(k5_err, worst)
        print(f"[chip_smoke] K5 B={B_} C={C_}: one valid position at the "
              f"start, middle and end of each of {splits} splits of {split}: "
              f"max abs {worst:.3e} (smallest bound {least:.1e})", flush=True)
    torch.cuda.empty_cache()
    k6_ties, k6_err = 0, 0.0
    k6_cases = [(B_, greedy, None, False) for B_ in (1, 8, 32)
                for greedy in (True, False)]
    k6_cases += [(8, True, (100, 101), False), (8, True, (100, 90000), False),
                 (8, False, None, True)]
    for B_, greedy, dup, pad in k6_cases:
        ties, bad, err = k6_case(B_, greedy, gen, dup, pad)
        k6_ties += ties
        k6_err = max(k6_err, err)
        print(f"[chip_smoke] K6 B={B_} V={V_PAD} v_real={V_REAL} "
              f"{'greedy' if greedy else 'gumbel'}"
              f"{f' duplicated rows {dup}' if dup else ''}"
              f"{' masked padded winner' if pad else ''}: near-tie "
              f"exceptions {ties}, violations {bad}, winning logit max abs "
              f"{err:.3e}", flush=True)
        check(bad == 0, "K6 breaks the near-tie rule against its plain "
              "version")
    torch.cuda.empty_cache()

    # ---- 8b. K4 against its plain version ----------------------------------
    k4_err = 0.0
    for B_, S_, H_, Hk_, D_, win, cap, dt in K4_CASES:
        err, bound = k4_case(B_, S_, H_, Hk_, D_, win, cap, dt, gen)
        if dt == torch.float32:
            k4_err = max(k4_err, err)
        print(f"[chip_smoke] K4 B={B_} S={S_} H={H_} Hk={Hk_} D={D_} "
              f"window={win} softcap={cap} {str(dt)[6:]}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, "K4 differs from its plain version")

    lap("8 K5, K6, K4 against their plain versions")

    # ---- 9. serving main path: prefill reuse + 63 decode steps -------------
    steps = SERVE["gen_len"] - 1
    print("[chip_smoke] serve main path: serve('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {SERVE})", flush=True)
    _, counts, speak = serve_path(
        "qwen2-0.5b", SERVE, {"k4": 0, "k5": K5_PER_CALL * 24 * steps,
                              "k6": steps, "k7": 0}, use_decode_kernel=True)
    k5_launches, k6_launches = counts["k5"], counts["k6"]
    cfg_full, sparams = full_params("qwen2-0.5b")
    ties, n_ids = teacher_forced(cfg_full, sparams)
    print(f"[chip_smoke] kernel vs plain decode, teacher-forced, full width: "
          f"{n_ids} ids, near-tie exceptions {ties}", flush=True)

    # ---- 10. continuous batching at full width -----------------------------
    print(f"[chip_smoke] serve_continuous('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {TRACE})", flush=True)
    flags = dict(use_decode_kernel=True)
    continuous_check("qwen2-0.5b", sparams, TRACE, flags, flags, {}, 24)
    # ---- 10b. long-prompt serve: K4 prefill, K5/K6 decode at C = 8224 -----
    steps = LONG["gen_len"] - 1
    print("[chip_smoke] long-prompt serve path: serve('qwen2-0.5b', "
          f"reduced=False, use_flash_kernel=True, use_decode_kernel=True, "
          f"{LONG})", flush=True)
    _, counts, lpeak = serve_path(
        "qwen2-0.5b", LONG, {"k4": 24, "k5": K5_PER_CALL * 24 * steps,
                             "k6": steps, "k7": 0},
        use_flash_kernel=True, use_decode_kernel=True)
    k4_launches = counts["k4"]
    lerr, lbound, cerr, cratio, lties, l_ids = long_teacher_forced(cfg_full,
                                                                   sparams)
    print(f"[chip_smoke] K4 path vs chunked plain path, teacher-forced, "
          f"full width, prompt {LONG['prompt_len']}: last logits max abs "
          f"{lerr:.3e} (bound {lbound:.3e}), caches max abs {cerr:.3e} "
          f"(worst layer at {cratio:.3f} of its bound), {l_ids} ids, "
          f"near-tie exceptions {lties}", flush=True)
    del sparams
    torch.cuda.empty_cache()

    lap("9-10b qwen2-0.5b serving")

    # ---- 12. K7 against its plain version ----------------------------------
    k7_err = 0.0
    for B_, S_, H_, P_, N_, Q_, a_, shared in K7_CASES:
        err, ratio, eps, cmax, groups = k7_case(B_, S_, H_, P_, N_, Q_, a_,
                                                shared, gen)
        k7_err = max(k7_err, err)
        stride0 = f" {shared} B/C groups as per-head copies" \
            if type(shared) is int else {
                True: " B/C head stride 0", "B": " B head stride 0, C per "
                "head", False: ""}[shared]
        print(f"[chip_smoke] K7 B={B_} S={S_} H={H_} P={P_} N={N_} Q={Q_} "
              f"A={'-linspace(1, 16)' if a_ is None else a_}{stride0} "
              f"({groups} G group{'s' if groups > 1 else ''}): max abs "
              f"{err:.3e}, worst error at {ratio:.3f} of its bound (bound "
              f"{eps:.2e} of the magnitude sum, max|cum| {cmax:.1f}); a "
              f"second call bitwise the first", flush=True)
        check(ratio <= 1.0, "K7 differs from its plain version")

    # ---- 12a. K7b against its plain VJP at the training route's shapes -----
    k7b_err = 0.0
    for shape in (K7B_CELL, K7B_P17, K7B_NEMO):
        err, ratio, eps, cmax = k7b_case(*shape, gen)
        k7b_err = max(k7b_err, err)
        groups = "B/C one group" if shape[-1] == 1 else (
            f"B/C {shape[-1]} groups as per-head copies, their dB and dC "
            f"summed over each group's heads")
        print(f"[chip_smoke] K7b (B, S, H, P, N, Q, G) = {shape}, {groups}, "
              f"A = -linspace(1, 16): max abs {err:.3e}, worst error at "
              f"{ratio:.2e} of its bound (bound {eps:.2e} of the plain VJP "
              f"at G groups on magnitudes, max|cum| {cmax:.1f}); a second "
              f"call bitwise the first", flush=True)
        check(ratio <= 1.0, "K7b differs from its plain VJP")

    # ---- 12c. K4's training instance and K4b: plain VJP, timed -------------
    k4b = phase_k4b(gen)

    # ---- 12b. K6 against its plain version at mamba2's head ----------------
    for B_, greedy in ((MAMBA["batch"], True), (MAMBA["batch"], False),
                       (MTRACE["slots"], True)):
        ties, bad, err = k6_case(B_, greedy, gen, head=MAMBA_HEAD)
        print(f"[chip_smoke] K6 B={B_} V={MAMBA_HEAD[0]} v_real="
              f"{MAMBA_HEAD[1]} d={MAMBA_HEAD[2]} "
              f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
              f"{ties}, violations {bad}, winning logit max abs {err:.3e}",
              flush=True)
        check(bad == 0, "K6 breaks the near-tie rule at mamba2's head")
    torch.cuda.empty_cache()

    # ---- 12c. K6 at heads wider than 2048 (y staged in slices over d) -----
    for name, head in WIDE_HEADS.items():
        worst = (0, 0, 0.0)
        for B_ in (1, 4, 8):
            for greedy in (True, False):
                ties, bad, err = k6_case(B_, greedy, gen, head=head)
                worst = (worst[0] + ties, worst[1] + bad, max(worst[2], err))
        k6_err = max(k6_err, worst[2])
        print(f"[chip_smoke] K6 {name} head (V={head[0]}, v_real={head[1]}, "
              f"d={head[2]}, slices of "
              f"{ds.sample_plan(8, head[2], head[1])[2]} at B=8), B 1/4/8, "
              f"greedy and gumbel: near-tie exceptions {worst[0]}, "
              f"violations {worst[1]}, winning logit max abs "
              f"{worst[2]:.3e}", flush=True)
        check(worst[1] == 0, f"K6 breaks the near-tie rule at {name}'s head")
    torch.cuda.empty_cache()

    # ---- 13. mamba2-1.3b serve: K7 prefill, K6 decode ----------------------
    steps = MAMBA["gen_len"] - 1
    flags = dict(use_decode_kernel=True)
    print("[chip_smoke] mamba2 serve path: serve('mamba2-1.3b', "
          f"reduced=False, {flags}, {MAMBA})", flush=True)
    _, counts, mpeak = serve_path(
        "mamba2-1.3b", MAMBA, {"k4": 0, "k5": 0, "k6": steps,
                               "k7": N_MAMBA_LAYERS}, **flags)
    k7_launches = counts["k7"]
    mcfg, mparams = full_params("mamba2-1.3b")
    lerr, lbound, cratio, mties, m_ids, cmax = mamba_teacher_forced(mcfg,
                                                                    mparams)
    print(f"[chip_smoke] K7 route vs plain-scan route, teacher-forced, full "
          f"width, prompt {MAMBA['prompt_len']}: last logits max abs "
          f"{lerr:.3e} (bound {lbound:.3e}, max|cum| {cmax:.1f}), cache "
          f"leaves at {cratio:.3f} of their bounds at worst, {m_ids} ids, "
          f"near-tie exceptions {mties}", flush=True)

    # ---- 13b. mamba2 continuous batching at full width ---------------------
    print(f"[chip_smoke] serve_continuous('mamba2-1.3b', reduced=False, "
          f"{flags}, {MTRACE})", flush=True)
    continuous_check("mamba2-1.3b", mparams, MTRACE, flags,
                     {}, {"k7": N_MAMBA_LAYERS}, 0)
    del mparams
    torch.cuda.empty_cache()

    # ---- 14. K4, K5, K6 and K7 timed at the serve paths' shapes ------------
    k5t, k5lt, k6t = (time_k5(K5_MAIN, gen, K5_MAIN_SPLITS),
                      time_k5(K5_LONG, gen, K5_LONG_SPLITS), time_k6(gen))
    for label, t in (("K5", k5t), (f"K5 at C={K5_LONG[1]}", k5lt)):
        alts = ", ".join(f"{sp}{' (plan)' if sp == t['plan'] else ''}: "
                         f"{a * 1e3:.2f} / {b * 1e3:.2f} us"
                         for sp, (a, b) in t["split_ms"].items())
        print(f"[chip_smoke] {label} at the serve path's shape: "
              f"{t['ms'] * 1e3:.2f} us/call back to back (2 launches), "
              f"plain {t['plain_ms'] * 1e3:.2f} us, library "
              f"{t['library_ms'] * 1e3:.2f} us; device time (CUDA graph of "
              f"50 calls) {t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_device_ms'] * 1e3:.2f} us, library "
              f"{t['library_device_ms'] * 1e3:.2f} us; bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B); by split "
              f"length, back to back / device: {alts}", flush=True)
    print(f"[chip_smoke] K6 at the serve path's shape: "
          f"{k6t['ms'] * 1e3:.2f} us/call, plain {k6t['plain_ms'] * 1e3:.2f} "
          f"us, library {k6t['library_ms'] * 1e3:.2f} us, bound "
          f"{k6t['bound_ms'] * 1e3:.3f} us ({k6t['bytes']} B)", flush=True)
    k6m = time_k6(gen, MAMBA["batch"], MAMBA_HEAD)
    print(f"[chip_smoke] K6 at mamba2's head (B={MAMBA['batch']}, "
          f"V={MAMBA_HEAD[0]}, v_real={MAMBA_HEAD[1]}, d={MAMBA_HEAD[2]}): "
          f"{k6m['ms'] * 1e3:.2f} us/call, plain {k6m['plain_ms'] * 1e3:.2f} "
          f"us, library {k6m['library_ms'] * 1e3:.2f} us, bound "
          f"{k6m['bound_ms'] * 1e3:.3f} us ({k6m['bytes']} B)", flush=True)
    for name in ("gemma3-4b", "deepseek-67b"):
        head = WIDE_HEADS[name]
        k6w = time_k6(gen, 8, head)
        print(f"[chip_smoke] K6 at {name}'s head (B=8, V={head[0]}, "
              f"v_real={head[1]}, d={head[2]}): {k6w['ms'] * 1e3:.2f} us/call,"
              f" plain {k6w['plain_ms'] * 1e3:.2f} us, library "
              f"{k6w['library_ms'] * 1e3:.2f} us, bound "
              f"{k6w['bound_ms'] * 1e3:.3f} us ({k6w['bytes']} B)",
              flush=True)
    k7t, k7o = time_k7(gen), time_k7(gen, K7_ONE)
    k7n = time_k7(gen, K7_NEMO, NEMO_GROUPS)
    for label, shape, t in (("the prefill's", K7_MAIN, k7t),
                            ("the continuous-batching prefill's", K7_ONE,
                             k7o),
                            (f"the nemotron cell's ({NEMO_GROUPS} B/C groups "
                             f"as per-head copies)", K7_NEMO, k7n)):
        print(f"[chip_smoke] K7 at {label} shape {shape}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back (2 launches), "
              f"device time (CUDA graph) {t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, whole plain SSD "
              f"(_ssd_chunked) "
              f"{t['chunked_ms'] * 1e3:.2f} us, whole K7 route (ops.ssd) "
              f"{t['route_ms'] * 1e3:.2f} us, library none, bound "
              f"{t['bound_ms'] * 1e3:.3f} us (operations: "
              f"{t['flops'] / 1e9:.3f} GFLOP, {t['groups']} G group(s); "
              f"bytes {t['bytes'] / 1e6:.1f} MB), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s, "
              f"{t['bound_ms'] / t['ms'] * 100:.1f} % of the bound "
              f"({t['bound_ms'] / t['device_ms'] * 100:.1f} % on device "
              f"time)", flush=True)
    k7bt, k7bp = time_k7b(gen), time_k7b(gen, K7B_P17)
    k7bn = time_k7b(gen, K7B_NEMO)
    for label, shape, t in (("the mamba2 cell's", K7B_CELL, k7bt),
                            ("phase 17's", K7B_P17, k7bp),
                            ("the nemotron cell's", K7B_NEMO, k7bn)):
        copies = "" if "copies_bound_ms" not in t else (
            f"; {t['copies_bound_ms'] * 1e3:.3f} us for the per-head "
            f"copies' work")
        print(f"[chip_smoke] K7b at {label} training shape "
              f"(B, S, H, P, N, Q, G) = {shape}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back (4 launches), "
              f"device time (CUDA graph) {t['device_ms'] * 1e3:.2f} us, "
              f"plain VJP {t['plain_ms'] * 1e3:.2f} us, library none, bound "
              f"{t['bound_ms'] * 1e3:.3f} us (operations: "
              f"{t['flops'] / 1e9:.3f} GFLOP, `ssd_scan.work_bwd` at G "
              f"groups; bytes {t['bytes'] / 1e6:.1f} MB{copies}), "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound "
              f"on device time", flush=True)
    k4t = time_k4(gen)
    print(f"[chip_smoke] K4 at the prefill's shape {K4_MAIN}: "
          f"{k4t['ms']:.3f} ms/launch, plain {k4t['plain_ms']:.3f} ms, "
          f"chunked models/flash.py {k4t['chunked_ms']:.3f} ms, SDPA "
          f"{k4t['library_ms']:.3f} ms, bound {k4t['bound_ms']:.3f} ms "
          f"(operations: {k4t['flops'] / 1e9:.1f} GFLOP; bytes "
          f"{k4t['bytes'] / 1e6:.1f} MB), achieved "
          f"{k4t['flops'] / k4t['ms'] / 1e9:.2f} TFLOP/s; clocks "
          f"max/now (MHz) {smi_line('clocks.max.sm,clocks.sm')}",
          flush=True)

    lap("12-14 mamba2 and K7, K6 timed")

    # ---- 10. the hybrid (zamba2-2.7b) and qwen3-4b at full width ---------
    p10 = phase10(gen)
    lap("10 zamba2 and qwen3-4b")

    # ---- 11. gemma3-4b at full width and depth ----------------------------
    p11 = phase11(gen)
    lap("11 gemma3-4b serving")

    # ---- 12. qwen2-moe-a2.7b at full width and depth ----------------------
    p12 = phase12(gen)
    lap("12 qwen2-moe-a2.7b serving")

    # ---- 13. deepseek-v2 (MLA, 4 layers), musicgen-large, internvl2-1b ----
    p13 = phase13(gen)
    lap("13 deepseek-v2, musicgen-large, internvl2-1b serving")

    # ---- 14. the mesh layer on a 1x1 card mesh; the examples --------------
    p14 = phase14()
    lap("14 the 1x1 mesh and the examples")

    # ---- 15. the dry run's cost model against the card ---------------------
    p15 = phase15()
    lap("15 the dry run against the card")

    # ---- 16. the mesh features on a 1x1 card mesh ---------------------------
    p16 = phase16()
    lap("16 the mesh features")

    # ---- 17. training of the families served only, at full width ----------
    p17 = phase17()
    lap("17 training the served-only families")

    # ---- phase 9. checkpoint and bitwise resume; the train_lm runner ------
    try:
        res = resume_phase(qwen_shapes)
        tlm = train_lm_phase()
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    lap("9 checkpoints and the train_lm runner")

    z, q3, ztr, ks = (p10["zamba"], p10["qwen3"], p10["train"],
                      p10["kernels"])
    g3, gks = p11["gemma3"], p11["kernels"]
    mo, mks = p12["moe"], p12["kernels"]
    dv2, mus, ivl, nks = (p13["dsv2"], p13["musicgen"], p13["internvl2"],
                          p13["kernels"])
    def train_paths(key):
        """K4's training instance or K4b on the training paths: the qwen2
        main path, 10d zamba2 (its shared block at D 80) and phase 17's
        transformer families (gemma3's D 256 takes neither)."""
        runs = p17["runs"]
        return {"qwen2-0.5b savic (main path)":
                    main_k4 if key == "k4" else main_k4b,
                "zamba2-2.7b 12-layer savic": ztr[key],
                **{f"{runs[lb]['arch']} {runs[lb]['layers']}-layer savic M 2 "
                   f"({lb})": runs[lb][key]
                   for lb in ("17b", "17c", "17d", "17e", "17i")}}

    by_path = {
        "k1": {"qwen2-0.5b savic": launches,
               "zamba2-2.7b 12-layer savic": ztr["k1"],
               "qwen2-0.5b 1x1 mesh plain savic": p14["b"]["k1"],
               "qwen2-0.5b 1x1 mesh plain savic (15b)":
                   p15["cases"]["14b"]["real"]["k1"],
               "qwen2-0.5b 1x1 mesh plain savic int8 + EF (16a)":
                   p16["a"]["k1"],
               "qwen2-0.5b 1x1 mesh plain savic --ckpt (16c)":
                   p16["c"]["k1"],
               **{f"{r['arch']} {r['layers']}-layer savic M 2 ({k})":
                  r["k1"] for k, r in p17["runs"].items()},
               **{f"{a} {p['layers']}-layer fused vs tree M 2 (17f)":
                  p["k1"] for a, p in p17["pairs"].items()},
               f"mamba2-1.3b {P17_INT8_LAYERS}-layer savic int8 + EF M 2 "
               "(17g)": p17["g"]["k1"],
               f"{MOE_ARCH} 1-layer bf16 compute M 2 (17h)": p17["h"]["k1"]},
        "k3": {"qwen2-0.5b savic int8 + EF": k3_launches,
               "qwen2-0.5b 1x1 mesh plain savic int8 + EF (16a)":
                   p16["a"]["k3"],
               f"mamba2-1.3b {P17_INT8_LAYERS}-layer savic int8 + EF M 2 "
               "(17g)": p17["g"]["k3"]},
        "k4": {"qwen2-0.5b long prompt": k4_launches,
               "zamba2-2.7b serve": z["counts"]["k4"],
               "zamba2-2.7b continuous": z["ccounts"]["k4"],
               "qwen3-4b serve": q3["counts"]["k4"],
               "gemma3-4b serve": g3["counts"]["k4"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k4"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k4"],
               "deepseek-v2-236b 4-layer serve": dv2["counts"]["k4"],
               "deepseek-v2-236b 4-layer continuous": dv2["ccounts"]["k4"],
               "musicgen-large serve": mus["counts"]["k4"],
               "internvl2-1b serve": ivl["counts"]["k4"],
               **train_paths("k4")},
        "k4b": train_paths("k4b"),
        "k5": {"qwen2-0.5b serve": k5_launches,
               "zamba2-2.7b serve": z["counts"]["k5"],
               "zamba2-2.7b continuous": z["ccounts"]["k5"],
               "qwen3-4b serve": q3["counts"]["k5"],
               "gemma3-4b serve": g3["counts"]["k5"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k5"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k5"],
               "musicgen-large serve": mus["counts"]["k5"],
               "internvl2-1b serve": ivl["counts"]["k5"]},
        "k6": {"qwen2-0.5b serve": k6_launches,
               "zamba2-2.7b serve": z["counts"]["k6"],
               "zamba2-2.7b continuous": z["ccounts"]["k6"],
               "qwen3-4b serve": q3["counts"]["k6"],
               "gemma3-4b serve": g3["counts"]["k6"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k6"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k6"],
               "deepseek-v2-236b 4-layer serve": dv2["counts"]["k6"],
               "deepseek-v2-236b 4-layer continuous": dv2["ccounts"]["k6"],
               "musicgen-large serve": mus["counts"]["k6"],
               "internvl2-1b serve": ivl["counts"]["k6"]},
        "k7": {"mamba2-1.3b serve": k7_launches,
               "zamba2-2.7b serve": z["counts"]["k7"],
               "zamba2-2.7b continuous": z["ccounts"]["k7"],
               "zamba2-2.7b 12-layer savic": ztr["k7"],
               "mamba2-1.3b 36-layer savic M 2 (17a)": p17["runs"]["17a"][
                   "k7"],
               f"mamba2-1.3b {P17_INT8_LAYERS}-layer savic int8 + EF M 2 "
               "(17g)": p17["g"]["k7"],
               f"{NEMO_17I} savic M 2 (17i)": p17["runs"]["17i"]["k7"]},
        "k7b": {"zamba2-2.7b 12-layer savic": ztr["k7b"],
                "mamba2-1.3b 36-layer savic M 2 (17a)": p17["runs"]["17a"][
                    "k7b"],
                f"mamba2-1.3b {P17_INT8_LAYERS}-layer savic int8 + EF M 2 "
                "(17g)": p17["g"]["k7b"],
                f"{NEMO_17I} savic M 2 (17i)": p17["runs"]["17i"]["k7b"]}}
    shape_times = lambda ts, shapes, keys=("ms", "plain_ms", "bound_ms",
                                           "copies_bound_ms", "library_ms",
                                           "library_backend",
                                           "device_ms"): [
        {"at": name, "shape": list(shapes[name]),
         **{k: t[k] for k in keys if k in t}} for name, t in ts.items()]
    kernels = [{
        "name": "fused_step_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/scaled_update.py:201",
        "launches": sum(by_path["k1"].values()),
        "launches_by_path": by_path["k1"], "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "scaled_update_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scaled_update.cu",
        "replaces": "src/repro/kernels/scaled_update.py:103",
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": k2_full["ms"], "plain_ms": k2_full["plain_ms"],
        "bound_ms": k2_full["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "quantize_update_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_update.cu",
        "replaces": "src/repro/kernels/quantize_update.py:56",
        "launches": sum(by_path["k3"].values()),
        "launches_by_path": by_path["k3"], "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_step.py:71",
        "launches": sum(by_path["k5"].values()),
        "launches_by_path": by_path["k5"],
        "max_abs_err": max(k5_err, ks["k5_err"], gks["k5_err"],
                           mks["k5_err"], nks["k5_err"]),
        "ms": k5t["ms"],
        "plain_ms": k5t["plain_ms"], "bound_ms": k5t["bound_ms"],
        "bound_by": "bytes", "library_ms": k5t["library_ms"],
        "device_ms": k5t["device_ms"],
        "at_shapes": shape_times({**ks["k5"], "gemma3": gks["k5"],
                                  "qwen2-moe": mks["k5"],
                                  "musicgen": nks["k5"]},
                                 {"zamba2": K5_ZAMBA, "qwen3": K5_QWEN3,
                                  "gemma3": K5_GEMMA,
                                  "qwen2-moe": K5_MOE,
                                  "musicgen": K5_MUSICGEN}),
    }, {
        "name": "decode_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_sample.cu",
        "replaces": "src/repro/kernels/decode_step.py:133",
        "launches": sum(by_path["k6"].values()),
        "launches_by_path": by_path["k6"],
        "max_abs_err": max(k6_err, ks["k6_err"], gks["k6_err"],
                           mks["k6_err"], nks["k6_err"]),
        "ms": k6t["ms"],
        "plain_ms": k6t["plain_ms"], "bound_ms": k6t["bound_ms"],
        "bound_by": "bytes", "library_ms": k6t["library_ms"],
        "at_shapes": shape_times({**ks["k6"], "gemma3-4b": gks["k6"],
                                  MOE_ARCH: mks["k6"],
                                  "deepseek-v2-236b": nks["k6"]}, {
            "zamba2-2.7b": (ZAMBA["batch"], *WIDE_HEADS["zamba2-2.7b"][:3]),
            "qwen3-4b": (QWEN3["batch"], *WIDE_HEADS["qwen3-4b"][:3]),
            "gemma3-4b": (GEMMA["batch"], *WIDE_HEADS["gemma3-4b"][:3]),
            MOE_ARCH: (MOE["batch"], *MOE_HEAD[:3]),
            "deepseek-v2-236b": (DSV2["batch"], *DSV2_HEAD[:3])}),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": sum(by_path["k4"].values()),
        "launches_by_path": by_path["k4"],
        "max_abs_err": max(k4_err, ks["k4_err"], gks["k4_err"],
                           mks["k4_err"], nks["k4_err"]),
        "ms": k4t["ms"],
        "plain_ms": k4t["plain_ms"], "bound_ms": k4t["bound_ms"],
        "bound_by": "operations", "library_ms": k4t["library_ms"],
        "at_shapes": shape_times(
            {**ks["k4"], "gemma3_global": gks["k4"]["global"],
             "gemma3_window1024": gks["k4"]["window"],
             "qwen2-moe": mks["k4"], "mla_dv128": nks["k4"]["mla"],
             "musicgen": nks["k4"]["musicgen"]},
            {"zamba2": K4_ZAMBA, "qwen3": K4_QWEN3,
             "gemma3_global": K4_GEMMA, "gemma3_window1024": K4_GEMMA,
             "qwen2-moe": K4_MOE, "mla_dv128": K4_MLA,
             "musicgen": K4_MUSICGEN}),
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": None,       # K4's VJP: the TPU kernel has none
        "launches": sum(by_path["k4b"].values()),
        "launches_by_path": by_path["k4b"],
        "launches_count": "calls (3 launches each, 4 where the rep heads "
                          "split)",
        "max_abs_err": k4b["err"], "max_err_over_bound": k4b["ratio"],
        "ms": k4b["times"]["qwen2_cell"]["ms"],
        "device_ms": k4b["times"]["qwen2_cell"]["device_ms"],
        "plain_ms": k4b["times"]["qwen2_cell"]["plain_ms"],
        "bound_ms": k4b["times"]["qwen2_cell"]["bound_ms"],
        "bound_by": "operations",
        "library_ms": k4b["times"]["qwen2_cell"]["library_ms"],
        "at_shapes": shape_times(k4b["times"],
                                 {"qwen2_cell": K4B_CELL,
                                  "nemotron_cell": K4B_NEMO}),
    }, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52",
        "launches": sum(by_path["k7"].values()),
        "launches_by_path": by_path["k7"],
        "max_abs_err": max(k7_err, ks["k7_err"]), "ms": k7t["ms"],
        "plain_ms": k7t["plain_ms"], "bound_ms": k7t["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "device_ms": k7t["device_ms"],
        "at_shapes": shape_times({**ks["k7"], "nemotron_cell": k7n},
                                 {"zamba2": K7_ZAMBA,
                                  "zamba2_one": K7_ZAMBA_ONE,
                                  "nemotron_cell": K7_NEMO}),
    }, {
        "name": "ssd_intra_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk_bwd.cu",
        "replaces": None,       # K7's VJP: the TPU kernel has none
        "launches": sum(by_path["k7b"].values()),
        "launches_by_path": by_path["k7b"], "max_abs_err": k7b_err,
        "ms": k7bt["ms"], "plain_ms": k7bt["plain_ms"],
        "bound_ms": k7bt["bound_ms"], "bound_by": "operations",
        "library_ms": None, "device_ms": k7bt["device_ms"],
        "at_shapes": shape_times({"phase17": k7bp, "nemotron_cell": k7bn},
                                 {"phase17": K7B_P17,
                                  "nemotron_cell": K7B_NEMO}),
    }]
    print(f"[chip_smoke] peak memory: savic {peak:.2f} GiB, savic int8 + EF "
          f"{cpeak:.2f} GiB, savic OASIS + participation 0.5 {rpeak:.2f} GiB, "
          f"serve {speak:.2f} GiB, long-prompt serve {lpeak:.2f} GiB, "
          f"mamba2 serve {mpeak:.2f} GiB; 8a H_m + async {het['peak']:.2f} "
          f"GiB (uniform H=4 {het['uniform_peak']:.2f}), 8b controller "
          f"{ctl['peak']:.2f} GiB (topk at embed.table {topk_ms:.2f} ms, "
          f"+{topk_gib:.2f} GiB), 8c objective + personal "
          f"{pers['peak']:.2f} GiB", flush=True)
    print(f"[chip_smoke] K1 launches on the knob paths: 8a {het['k1']}, 8b "
          f"{ctl['k1']}, 8c {pers['k1']}, 8d {k1_8d_hm} (H_m) and "
          f"{k1_8d_ctrl} (controller)", flush=True)
    a = res["a"]
    print(f"[chip_smoke] phase 9: 9a savic M = {res['M']} checkpoint "
          f"{a['size']} B (n = {res['n']}), {io_line(a['io_b'])}; K1 "
          f"{a['k1'][0]} vs {a['k1'][1]} + {a['k1'][2]}; 9b K1 "
          f"{[b['k1'] for b in res['b']]}, K3 {[b['k3'] for b in res['b']]};"
          f" 9c K1 {tlm['k1']} + {tlm['k1_full']}", flush=True)
    print(f"[chip_smoke] phase seconds {json.dumps(lap.secs)}", flush=True)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
