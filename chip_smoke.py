#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,codec

Phases, each printing its lines; any failure exits non-zero:

1. build  -- print the card's name and power limit, build the CUDA
             kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
             process for each source, all at once (wire.cu, stage.cu,
             rdma.cu, allreduce.cu and crc.cu).
2. codec  -- the CUDA encode reproduces every raw golden wire vector of
             ``tests/golden/wire_vectors.npz`` byte for byte, and each
             ``_rot`` key within the CPU tests' bound (at most 1% of bytes
             differ; the CUDA decode of the golden equals the plain decode
             on the CPU bit for bit); for scale_int, fp16-meta, rotation
             and edge-case configs the kernels equal their plain PyTorch
             versions on the card (encode bytes, decode bits,
             decode+reduce bits, on the edge input with NaN payloads in
             f32, bf16 and fp16 out, and at (1 | 2 | 8 | 9, 4096)); each
             config's encode also on tie input (_tie_input: values whose
             (v - z) / s is k + 1/2 or one float32 ulp beside it).
             The framed wire: the 9 ``frame_int*`` goldens byte for byte
             from the CUDA codec (``core/codec.py`` with a framed config:
             fc_encode_wire, then the frame with fc_crc32c), their CUDA
             decode bit-equal to the unframed decode, and each one
             self-describing on the host (``frame.frame_decode``);
             fc_crc32c (the CRC kernel, no Pallas counterpart) equal to
             its plain version and to the host ``frame.crc32c`` on the
             check vector, rows of 1 to 3 bytes, lengths L - 1, L and
             L + 1 around a word, 16 bytes, its chunk, its tile, its ring
             of tiles and a block's run of tiles (_crc_cases), several
             rows, contiguous rows, framed rows' payloads and rows at a
             pitch of 3 + L, each case naming its path (the ring of bulk
             copies or the synchronous load; both are hit), and equal to
             its plain version at a leaf-sized row (2 rows of llama3-8b's
             embedding leaf at pod = 2, int8 g128); then every byte of
             one framed row flipped in turn (three configs): the CUDA
             codec's decode NaN-poisons exactly that row and leaves the
             others bit-equal.
   crc    -- fc_crc32c at the framed pod bridge's rows of llama3-8b's
             embedding leaf (the pod site's (8, 67719168) and the leaf's
             halves (2, 270876672), on the kernel's ring) and at the pod
             site's length at a pitch of 3 + L (its synchronous path):
             bit-equal to its plain version; CUDA events (median of 5)
             beside the bound and the plain version's time, and each
             launch's device time from torch.profiler (phase_crc).
3. stage  -- the per-stage kernels (quant_pack, dequant_unpack,
             spike_pack) equal their plain versions byte for byte (payload,
             scale, zero, spike values and indices) and bit for bit
             (dequantized values) at the serving path's two shapes, at
             (64, 4096) and on the edge input, for STAGE_SWEEP with f32 and
             bf16 input, and the packs on each config's tie input, with
             exact launch counts. Then their entry points
             (``repro_torch.kernels.fused_*``) are driven at the prefill
             site's shape with the counts zeroed before and read after.
4. time   -- at the serving path's two shapes, the prefill's
             (1, BATCH*PROMPT_LEN*d_model) and the decode step's
             (1, BATCH*d_model), and for the two decodes at the other
             shapes of _path_time_rows (moonshot's TP sites and dispatch
             receive, tp = 2's rows, a 4-row decode+reduce): each kernel
             equals its plain version, and its device time from
             torch.profiler traces (the mean over the launches a trace of
             25 calls recorded) and its time per call with CUDA events
             (median of 25 calls after 5 warm-up calls) stand beside the
             plain version's and the bound.
5. serve  -- qwen3-14b at full width (40 layers, bf16 weights from seed
             SEED by the JAX package's init rules, with the zero-initialised
             attention and MLP output projections filled from a fan-in
             normal so that every site carries data). For each policy, the
             prefill's hidden states and DECODE_CHECK_STEPS decode steps'
             logits through the CUDA kernels equal those through the plain
             codec on the card, bit for bit. Then it serves BATCH x
             PROMPT_LEN prompt tokens + GEN generated tokens under
             SERVE_RUNS (paper/two_step, paper/fused; aggressive/two_step
             is checked above but no longer served), and without the
             codec (bf16). The launch counts of every kernel
             are zeroed just before these runs and read just after; each
             wire kernel must have run the expected number of times and
             each stage kernel none, and prefill and decode must agree on
             the first generated token
             (``repro_torch.launch.serve.prefill_decode_agreement``; the
             run without the codec to CACHE_REL_TOL). Then
             ``window_override`` (_serve_window): every block given a
             window of WINDOW, the prefill over PROMPT_LEN positions and
             DECODE_CHECK_STEPS decode steps on a ring of WINDOW_CHECK
             slots (wrapped) through the CUDA codec equal to the plain
             codec's bit for bit (paper), then served under bf16 with a
             ring of WINDOW slots that the prompt wraps: prefill/decode
             agreement to CACHE_REL_TOL, every ring holding the last
             WINDOW positions.
   ln     -- command-r-35b (LayerNorm) at full width, its depth cut to
             LN_REPEATS layers (weights from seed SEED, output
             projections filled): paper/two_step's prefill hidden states
             and DECODE_CHECK_STEPS decode steps' logits through the CUDA
             kernels equal the plain codec's bit for bit; then it serves
             LN_RUNS (paper/two_step, bf16) with exact launch counts,
             every norm a LayerNorm (counted: 2 a layer and the final one
             a forward) and prefill/decode agreement (bf16 to
             CACHE_REL_TOL).
6. a2a    -- the peer-push All2All kernel (fc_a2a, one launch a call, its
             grid sized by the call) in a loopback world of tp ranks on
             the card, tp in A2A_TPS, at moonshot's dispatch shapes with
             ep = tp (m = (E / tp) * capacity rows of d_model a rank and
             peer, at prefill and at decode), bf16 payload (and f32 for
             the paper config at the smallest tp), for A2A_CONFIGS
             (rotation included): A2A_CALLS back-to-back calls with fresh
             inputs in one world at each shape, then A2A_CALLS that
             alternate the two shapes (so the grid changes from call to
             call), none with a sync between them; each output bit-equal
             to the plain version's, the last call's receive buffers
             byte-equal, the signal pads at the world's running targets
             and the launch counts exact; then its time at both shapes,
             at tp = A2A_TIME_TP (the paper config and the spike one) and
             at the serve path's tp = TP.
7. moe    -- moonshot-v1-16b-a3b at full width (1 dense and MOE_REPEATS
             of its 47 MoE blocks with 64 experts, top-6), weights from
             seed SEED with the
             zero-initialised output projections (attention, MLP and
             experts) filled. For each policy the prefill's hidden states
             and DECODE_CHECK_STEPS decode steps' logits through the CUDA
             kernels equal those through the plain codec, bit for bit;
             then it serves BATCH x PROMPT_LEN + GEN tokens under the
             policies of phase serve (SERVE_RUNS and bf16; its
             aggressive/two_step run checked but not served, cut to pay
             for phase rec), with exact launch counts (a TP
             site a block and the embedding's, a dispatch site an MoE
             block, a forward), and prints TTFT,
             ms/step and the routes dropped over capacity. Prefill and
             decode route with different capacities, so their agreement
             is not checked here (the CPU tests hold both against JAX).

8. ar     -- the fused AllReduce's kernel (fc_ar, one launch a call, its
             grid sized by the call) in loopback worlds of tp ranks on
             the card, tp in AR_TPS, at qwen3-14b's TP-site shapes per
             rank (n = BATCH*PROMPT_LEN*d_model and BATCH*d_model), for
             AR_CONFIGS: AR_CALLS back-to-back calls with fresh inputs in
             one world at each shape, then AR_CALLS that alternate the
             two shapes (so the grid changes from call to call), none
             with a sync between them; each output bit-equal to the
             plain version's, the last call's receive rows of both
             phases byte-equal, the signal pads at the world's running
             targets and the launch counts exact; then its time at
             tp = AR_TIME_TP at both shapes, the paper config (with its
             step stamps) and the spike one.
9. tp     -- --mesh 1,TP, one rank a process (started with subprocess;
             all TP ranks share the one card and a gloo group, and their
             kernels take turns on it), the peer world's receive rows
             sized for both models' sites (launch/mesh.py
             site_row_bytes). Each rank: fc_ar (TP_PROBE_CALLS
             back-to-back calls at the decode shape) and fc_a2a
             (moonshot's prefill and decode dispatch, A2A_CALLS each)
             through PeerWorld.from_group (CUDA IPC), each call timed
             between the processes, bit-equal to the plain versions of all
             ranks' inputs, with exact pads. Then qwen3-14b (TP_REPEATS
             layers) and, its weights freed, moonshot-v1-16b-a3b (ep =
             TP; its dense block and TP_MOE_REPEATS MoE blocks) at full
             width, weights from seed SEED (init_params(rank=r), output
             projections filled): paper/fused's prefill hidden states and
             DECODE_CHECK_STEPS decode logits bit-equal to
             paper/two_step's; then it serves BATCH x TP_PROMPT + TP_GEN
             tokens under DENSE_TP_RUNS (qwen3-14b) and MOE_TP_RUNS
             (moonshot): paper/fused (every TP site through fc_ar, every
             dispatch through fc_a2a), with exact launch counts (fc_ar
             once a TP site, fc_a2a once a dispatch; no wire kernel), the
             dense run's prefill/decode agreement and moonshot's dropped
             routes (tp4, ep8 and rec also serve paper/two_step: the wire
             kernels around the host-staged gloo hop). Rank 0
             prints TTFT and ms/step, every rank its peak memory; a failed
             rank fails the phase.
   tp4    -- glm4-9b at --mesh 1,GLM_TP (four rank processes on the card;
             its two kv heads replicated, the decode cache a sequence-
             sharded ring), its depth cut to GLM_REPEATS layers: fc_ar
             (GLM_PROBE_CALLS calls) through a PeerWorld.from_group of
             four processes, timed between them; then as phase tp:
             paper/fused == paper/two_step bit for bit on every rank,
             TP_RUNS served with exact launch counts and the ring's
             merges counted (one a layer and decode step), prefill/decode
             agreement, every rank the same tokens.

10. train -- llama3-8b trained at full width, its depth cut to
             TRAIN_REPEATS layers, global batch TRAIN_BATCH x seq
             TRAIN_SEQ, TRAIN_STEPS steps a run, float32 store and AdamW
             moments from seed SEED (init_store, the zero-initialised
             output projections filled). First fc_encode_wire,
             fc_decode_wire and fc_decode_reduce against their plain
             versions (bit for bit, the plain versions in TRAIN_PIECE-column
             pieces) at the embedding gradient leaf (1, 525336576), its
             two-rank split and a stacked MLP leaf, for TRAIN_LEAF_CONFIGS,
             and their times. Then --mesh 1,1 in this process: bf16, paper
             through the CUDA codec, and paper through the plain codec for
             TRAIN_CHECK_STEPS steps: loss, grad norm and every parameter
             bit-equal, paper's step-0 loss within TRAIN_LOSS_REL of
             bf16's. Then TRAIN_MESHES, one rank process a rank on the
             card: --mesh 1,1,2 (pod = 2): paper/two_step and paper/fused
             (the grad site through fc_ar in the pod axis's peer world)
             bit-equal on every rank over TRAIN_CHECK_STEPS steps, then
             depth (2-bit grad site with error feedback: the residual
             non-zero); --mesh 2,1 (fsdp = 2): aggressive (the qag gather
             at int4 scale_int, the qgrad_rs reduce-scatter at int8,
             tp_bwd). Every run: the launches of every step exact
             (_train_expected), ms/step (median and p90 of the steps
             after the first, host clock, synchronised), tokens/s, peak
             memory.
   moe_train -- moonshot-v1-16b-a3b trained at full width, its dense
             prefix block and TRAIN_MOE_REPEATS MoE blocks (64 experts,
             top-6), TRAIN_BATCH x TRAIN_SEQ tokens a step: --mesh 1,1 in
             this process, paper through the CUDA codec == the plain
             codec over TRAIN_CHECK_STEPS steps; then TRAIN_MOE_MESHES
             (--mesh 1,2, ep = 2): paper/fused (the TP sites through
             fc_ar, the dispatch through fc_a2a, forward and replayed)
             == paper/two_step bit for bit on both ranks. Exact launches
             every step, the routes dropped over capacity, ms/step, peak
             memory.

11. moe_archs -- grok-1 (GeGLU experts, top-2; 4 of its 64 MoE blocks,
             42.6 GB) and llama4-maverick (top-1 over 128 experts; one
             (dense, moe) repeat of 24, 36.9 GB) at full width, tp = 1,
             as phase moe: paper/two_step's prefill hidden states and
             DECODE_CHECK_STEPS decode steps' logits through the CUDA
             kernels equal the plain codec's bit for bit; MOE_ARCH_RUNS
             served with exact launch counts, TTFT, ms/step, the routes
             dropped and peak memory.
12. ep8   -- grok-1's smoke config at --mesh 1,EP_TP (ep 4 x etp 2, its
             two kv heads replicated: the decode ring at tp = 8), EP_TP
             rank processes on the card, each with three peer worlds
             (the model axis's and its ep and etp subaxes'): fc_ar
             through the model and etp worlds and fc_a2a through the ep
             world, timed between the processes, bit-equal to the plain
             versions; paper/fused == paper/two_step bit for bit on
             every rank (prefill, decode steps), both served (EP_GEN
             tokens) with exact launch counts (fused: fc_ar at every TP
             site and every within-expert AllReduce, fc_a2a at every
             dispatch), the same tokens and routes dropped; then trained
             EP_TRAIN_MESHES (paper/fused == paper/two_step over
             EP_TRAIN_STEPS steps, finite losses).

13. rec    -- recurrentgemma-2b (RG-LRU + local attention, 26 blocks,
             5.61 GB) and xlstm-125m (mLSTM / sLSTM, no positions, 12
             blocks) at full width and full depth, tp = 1, weights from
             seed SEED (the output projections and the recurrent
             mixers' gate vectors and biases filled, so that the gates
             depend on the data):
             paper/two_step's prefill hidden states and
             DECODE_CHECK_STEPS decode steps' logits through the CUDA
             kernels equal the plain codec's bit for bit; REC_RUNS
             served with exact launch counts (_tp_sites: 53 TP sites a
             forward in recurrentgemma, 13 in xlstm), TTFT, ms/step, peak
             memory and prefill/decode agreement (bf16 to
             CACHE_REL_TOL). Between the two, recurrentgemma's (rec, rec,
             local) repeat alone served REC_WINDOW_PROMPT tokens, past
             its window of 2048, and REC_WINDOW_GEN more under bf16: the
             local ring has exactly 2048 slots, each then within the
             window (_rec_window). After each model's served runs, on
             the same weights, the kernels one prefill and one decode
             step launch (a torch.profiler trace of one call: count and
             device time, beside the call's host time; _census).
             Then xlstm-125m
             at --mesh 1,TP, its depth cut to XLSTM_TP_REPEATS repeats,
             two rank processes as phase tp's: paper/fused ==
             paper/two_step bit for bit on both ranks (prefill, decode
             steps), paper/fused served (XLSTM_TP_RUNS), fc_ar launches
             counted.
14. xattn  -- whisper-tiny (encoder-decoder: 4 enc blocks over 1500
             frames, 4 dec blocks, learned positions, LayerNorm, biases;
             0.14 GB) at full width and depth, and llama-3.2-vision-11b
             (image cross-attention over 1600 patches) at full width,
             its depth cut to VISION_REPEATS of 8 (xattn, dense x 4)
             repeats, tp = 1, weights from seed SEED (the output
             projections and, whisper's, every bias filled); the stub
             frontend's embeddings from the data stream (_serve_inputs)
             in every forward, the decode steps' too (the encoder runs
             again each step, as in the JAX package): paper/two_step's
             prefill hidden states and DECODE_CHECK_STEPS decode steps'
             logits through the CUDA kernels equal the plain codec's bit
             for bit; XATTN_RUNS served with exact launch counts
             (_tp_sites: 21 TP sites a forward in each, whisper's 8
             encoder sites included), TTFT, ms/step, peak memory and
             prefill/decode agreement (bf16 to CACHE_REL_TOL); then
             _census on the same weights (whisper's encoder pass alone
             beside its decode step). Then whisper-tiny at --mesh 1,TP,
             full depth, two rank processes as phase tp's (the peer
             world's rows sized for BATCH x 1500 encoder tokens):
             paper/fused == paper/two_step bit for bit on both ranks
             (prefill, decode steps), paper/fused served
             (XATTN_TP_RUNS) with one fc_ar launch a TP site.
   kinds_train -- the recurrent, sliding-window, encoder and
             cross-attention kinds trained at full width, TRAIN_BATCH
             rows a step (KINDS_TRAIN): recurrentgemma-2b (its (rec,
             rec, local) repeat and (rec, rec) suffix, 5 of 26 blocks),
             xlstm-125m (12 blocks; KINDS_XLSTM_SEQ tokens a row, its
             cells a Python loop over the sequence), whisper-tiny (4 enc
             + 4 dec blocks) and llama-3.2-vision-11b (one (xattn, dense
             x 4) repeat of 8) at TRAIN_SEQ, float32 store and AdamW
             moments from seed SEED (init_store; the zero output
             projections, gate vectors and biases filled), the encoder
             archs on the stream's stub embeddings. Each at --mesh 1,1
             in this process: bf16, paper through the CUDA codec and
             paper through the plain codec for TRAIN_CHECK_STEPS steps:
             loss, grad norm and every parameter bit-equal, paper's
             step-0 loss within KINDS_LOSS_REL of bf16's; then
             whisper-tiny at --mesh 1,2 (KINDS_TRAIN_MESHES), two rank
             processes: paper/fused (every TP site through fc_ar, the
             encoder's 8 and their replay and tp_bwd included) ==
             paper/two_step bit for bit on both ranks. Every run: the
             launches of every step exact (_train_expected: KIND_SITES
             a block, the encoder's at their own b_loc x n_ctx x
             d_model), ms/step (median and p90 of the steps after the
             first), tokens/s, peak memory a rank.
15. dp     -- data-parallel serving (--mesh D,M, D > 1; DP_CELLS):
             qwen3-14b at full width, DP_LAYERS layers, a float32 flat
             store from seed SEED (output projections filled; _dp_store)
             sharded over the data axis, BATCH rows split over the
             replicas, DP_PROMPT prompt tokens + DP_GEN; one rank process
             a rank on the card (dp_rank_main), every prefill and decode
             step gathering every block group over the data axis (gloo,
             staged through host memory), as the JAX package's serve
             does. --mesh 2,1: aggressive (the qag site at int4 g32
             scale_int): the prefill's and DP_CHECK_STEPS decode steps'
             logits through the CUDA codec equal the plain codec's bit
             for bit; paper/two_step and aggressive served; every
             logits of the served paper/two_step run (the gather exact)
             equal, bit for bit, its replica's rows served alone at
             --mesh 1,1 from the whole store on the gather road
             (fsdp = 1), the same tokens fed (_dp_alone, in this
             process). --mesh 2,2: paper/fused (fc_ar at the TP sites)
             served, its prefill's and first DP_CHECK_STEPS decode
             steps' logits equal paper/two_step's bit for bit. Every
             served run with exact launch counts (a TP site's two
             encodes and two decodes, or one fc_ar; one fc_encode_wire
             and one fc_decode_wire a qag gather, _qag_gathers a
             forward), TTFT, ms/step (rank 0's clock) and peak memory a
             rank. Then fc_encode_wire and fc_decode_wire at the largest
             qag shape (embed/tok's shard at fsdp = 2, (1, 388956160) f32,
             and its two wires decoded) against their plain versions and
             the bound (_dp_qag_time).

In phase train, --mesh 1,1,2 also runs paper/two_step with
``--framed-bridge 8`` (policy.with_framed_bridge: the pod hop int8 g128
hier_pp in frames, each wire row's CRC through fc_crc32c) for
TRAIN_CHECK_STEPS steps: its loss, grad norm and every parameter equal
paper/two_step's bit for bit (the bridge's one-axis hier_pp batches the
microchunks through the two-step, and a group's codes do not depend on
where its chunk lies, so the frame is pure envelope;
tests/test_torch_frame.py shows the two equal on the CPU), with exact
launch counts (one fc_crc32c a framed encode and one a framed decode)
and no NaN in any parameter.

The line before the last is a JSON object with one entry per kernel
(``launches``: the wire kernels' from the serve, ln, moe, train,
moe_train, moe_archs, rec, xattn, kinds_train and dp paths, the stage
kernels' from their entry points, fc_a2a's from phase tp's moonshot runs
on rank 0 and phases moe_train's and ep8's, fc_ar's from phase tp's and
tp4's served runs and phases train's, moe_train's, ep8's, rec's,
xattn's, kinds_train's and dp's runs on rank 0;
``serve_launches``, ``ln_launches``, ``moe_launches``, ``tp_launches``,
``moe_tp_launches``, ``glm_tp_launches``, ``train_launches``,
``moe_train_launches``, ``moe_archs_launches``, ``ep8_launches``,
``ep8_train_launches``, ``rec_launches``, ``xattn_launches``,
``kinds_train_launches`` and ``dp_launches``: from those paths); a ``[phase] NAME: SECONDS`` line follows each phase; the last
line is ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "wire_vectors.npz")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
PHASES = ("build", "codec", "crc", "stage", "time", "serve", "ln", "a2a",
          "moe", "ar", "tp", "tp4", "train", "moe_train", "moe_archs", "ep8",
          "rec", "xattn", "kinds_train", "dp")
CSRC = "src/repro_torch/kernels/csrc/"
WIRE_KERNELS = ("encode_wire", "decode_wire", "decode_reduce")
STAGE_KERNELS = ("quant_pack", "dequant_unpack", "spike_pack")
# the TPU kernel each CUDA kernel replaces; fc_crc32c replaces none (JAX's
# crc32c_rows is a byte-serial lax.scan in jnp): the file:line given is
# that function
REPLACES = {"encode_wire": "src/repro/kernels/wire.py:58",
            "decode_wire": "src/repro/kernels/wire.py:100",
            "decode_reduce": "src/repro/kernels/emulate.py:110",
            "quant_pack": "src/repro/kernels/quant_pack.py:54",
            "dequant_unpack": "src/repro/kernels/dequant_unpack.py:42",
            "spike_pack": "src/repro/kernels/spike_reserve.py:46",
            "a2a": "src/repro/kernels/rdma_all2all.py:75",
            "ar": "src/repro/kernels/rdma_allreduce.py:154",
            "crc32c": "src/repro/core/frame.py:122"}
# (bits, group): SWEEP of tests/test_kernels.py, and its spike configs
STAGE_SWEEP = ((8, 128), (6, 128), (5, 128), (4, 32), (3, 32), (2, 32),
               (7, 128))
STAGE_SPIKE = ((2, 32), (3, 32), (4, 32))
RUNS = (("paper/two_step", "paper", None),
        ("paper/fused", "paper", "fused"),
        ("aggressive/two_step", "aggressive", None))
# No codec: every site is the exact sum. It times the path without the
# codec, and holds the cache to a tighter bound than the quantized runs
# can: unquantized, prefill and decode differ by bf16 rounding only
# (about 0.02 of the logits' spread at full width on one H100).
BASELINE = ("bf16", "bf16", None)
# phase serve's served runs: its aggressive/two_step run was cut to pay
# for phases moe_archs and ep8 (its prefill and decode steps are still
# held against the plain codec's bit for bit)
SERVE_RUNS = RUNS[:2]
# phase moe's served runs: its aggressive/two_step run was cut to pay for
# phase rec (checked as phase serve's is)
MOE_CHECK_ONLY = RUNS[2:]
CACHE_REL_TOL = 0.1
# the std of a biased model's filled biases (_fill_output_projections)
BIAS_STD = 0.05
ARCH = "qwen3-14b"
MOE_ARCH = "moonshot-v1-16b-a3b"
BATCH, PROMPT_LEN, GEN, SEED = 4, 128, 16, 0
A2A_TPS = (2, 4, 8)
A2A_CALLS = 10
A2A_TIME_TP = 4
A2A_CONFIGS = (("paper int4 g32", dict(bits=4, group=32)),
               ("aggressive int4 g32 scale_int", dict(bits=4, group=32,
                                                      scale_int=True)),
               ("int2 g32 spike", dict(bits=2, group=32, spike=True)),
               ("int2 g32 rotation", dict(bits=2, group=32,
                                          rotation=True)))
AR_TPS = (2, 4, 8)
AR_CALLS = 10
AR_TIME_TP = 4
AR_CONFIGS = (("paper int8 g128", dict(bits=8, group=128)),
              ("aggressive int5 g128 scale_int", dict(bits=5, group=128,
                                                      scale_int=True)),
              ("int2 g32 spike", dict(bits=2, group=32, spike=True)))
AR_SCATTER, AR_GATHER, A2A_COLLECTIVE = 0, 1, 2   # kernels/protocol.py ids
TP = 2                             # phase tp: --mesh 1,TP
TP_PROBE_CALLS = 100
# phase tp's served runs of both models (its qwen3-14b bf16 run and 12
# of its GEN generated tokens were cut to pay for phases ln, tp4 and
# moe_train; moonshot's paper/two_step run to pay for phase train's
# framed-bridge run, qwen3-14b's to pay for phase rec: their prefill and
# decode steps are still held against paper/fused's bit for bit before
# the served runs)
TP_RUNS = (("paper/fused", "paper", "fused"),
           ("paper/two_step", "paper", None))
DENSE_TP_RUNS = MOE_TP_RUNS = TP_RUNS[:1]
TP_GEN = 4
# the rank-process cells' served runs (TP_CELLS): BATCH x TP_PROMPT prompt
# tokens (cut from PROMPT_LEN to 32 to pay for phase dp, then to 16 for
# phase kinds_train: each prompt token is a decode step of turns on the
# card), the checks before them still at PROMPT_LEN; TP_PROMPT + the
# generated tokens a multiple of tp in replicate mode (the ring)
TP_PROMPT = 16
TP_TIMEOUT_S = 900
# phase tp's depth, cut to pay for phases moe_archs and ep8: qwen3-14b's
# 40 layers to TP_REPEATS (20, then 10 to pay for phase dp, then 6 for
# phase kinds_train), moonshot's 47 MoE blocks (after its dense one) to
# TP_MOE_REPEATS (15, then 5 for phase dp)
TP_REPEATS = 6
TP_MOE_REPEATS = 5
# phase moe's moonshot (tp = 1): its 47 MoE blocks cut to MOE_REPEATS,
# for the same reason (23, then 11 to pay for phase xattn, then 5 for
# phase kinds_train)
MOE_REPEATS = 5
# phase tp4: glm4-9b at --mesh 1,GLM_TP, its two kv heads replicated (the
# decode cache a sequence-sharded ring), its 40 layers cut to GLM_REPEATS
# (4, then 2 to pay for phase kinds_train)
GLM_ARCH = "glm4-9b"
GLM_TP = 4
GLM_REPEATS = 2
GLM_PROBE_CALLS = 25
# phase ln: command-r-35b (LayerNorm) at tp = 1, its 40 layers cut to
# LN_REPEATS (8, then 4 to pay for phase kinds_train)
LN_ARCH = "command-r-35b"
LN_REPEATS = 4
LN_RUNS = (("paper/two_step", "paper", None), BASELINE)
DECODE_CHECK_STEPS = 4
# phase train: llama3-8b at full width, its 32 layers cut to TRAIN_REPEATS;
# TRAIN_STEPS steps a run (4, then 2 to pay for phase kinds_train: ms/step
# is then the second step's)
TRAIN_ARCH = "llama3-8b"
TRAIN_REPEATS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 2
TRAIN_CHECK_STEPS = 2              # CUDA == plain codec, fused == two_step
# paper's step-0 loss against bf16's at --mesh 1,1, relative: 9.0e-6 on
# the H100; 2.0e-4 with every decoded value one code step high (a fault
# planted in a copy)
TRAIN_LOSS_REL = 5e-5
TRAIN_TIMEOUT_S = 600
TRAIN_PIECE = 1 << 24              # columns of a plain-version piece
FRAMED_LABEL = "paper/two_step framed-bridge 8"
TRAIN_LEAF_CONFIGS = (("int8 g128", dict(bits=8, group=128)),
                      ("int2 g32 spike", dict(bits=2, group=32, spike=True)),
                      ("int4 g32 spike scale_int",
                       dict(bits=4, group=32, spike=True, scale_int=True)))
#: the multi-rank cells: mesh DATA,MODEL[,POD] -> (label, policy, scheme,
#: --framed-bridge bits or None, steps)
TRAIN_MESHES = (("1,1,2", (("paper/two_step", "paper", None, None,
                            TRAIN_STEPS),
                           ("paper/fused", "paper", "fused", None,
                            TRAIN_STEPS),
                           (FRAMED_LABEL, "paper", None, 8,
                            TRAIN_CHECK_STEPS),
                           ("depth", "depth", None, None, TRAIN_STEPS))),
                ("2,1", (("aggressive", "aggressive", None, None,
                          TRAIN_STEPS),)))
# phase moe_train: moonshot-v1-16b-a3b at full width, its dense prefix
# block and TRAIN_MOE_REPEATS MoE blocks; --mesh 1,1 in process, then
# TRAIN_MOE_MESHES as rank processes
TRAIN_MOE_REPEATS = 1
TRAIN_MOE_MESHES = (("1,2", (("paper/two_step", "paper", None, None,
                              TRAIN_STEPS),
                             ("paper/fused", "paper", "fused", None,
                              TRAIN_STEPS))),)
# phase moe_archs: grok-1 and llama4-maverick at full width, tp = 1, their
# depth cut to MOE_ARCHS' layer counts (grok-1 4 of 64 MoE blocks,
# llama4-maverick one (dense, moe) repeat of 24), served under
# MOE_ARCH_RUNS
MOE_ARCHS = (("grok-1-314b", 4), ("llama4-maverick-400b-a17b", 1))
MOE_ARCH_RUNS = (("paper/two_step", "paper", None), BASELINE)
# phase ep8: grok-1's smoke config at --mesh 1,EP_TP (ep 4 x etp 2, its two
# kv heads replicated: the decode ring at tp = 8), EP_TP rank processes on
# the card; EP_GEN tokens generated (TP_PROMPT + EP_GEN a multiple of
# EP_TP, as the ring needs), then trained EP_TRAIN_MESHES
EP_ARCH = "grok-1-314b"
EP_TP = 8
EP_GEN = 8
EP_PROBE_CALLS = 25
EP_TRAIN_STEPS = 2
EP_TRAIN_MESHES = (("1,8", (("paper/two_step", "paper", None, None,
                             EP_TRAIN_STEPS),
                            ("paper/fused", "paper", "fused", None,
                             EP_TRAIN_STEPS))),)
# phase rec: recurrentgemma-2b (RG-LRU + local attention) and xlstm-125m
# (mLSTM / sLSTM) at full width and full depth, tp = 1, served under
# REC_RUNS; recurrentgemma's (rec, rec, local) repeat alone (no suffix)
# served REC_WINDOW_PROMPT tokens, past its window of 2048, under bf16;
# xlstm-125m at --mesh 1,TP, its 6 repeats cut to XLSTM_TP_REPEATS
REC_ARCH = "recurrentgemma-2b"
XLSTM_ARCH = "xlstm-125m"
REC_RUNS = (("paper/two_step", "paper", None), BASELINE)
# (REC_WINDOW_GEN 8, then 4 to pay for phase kinds_train)
REC_WINDOW_PROMPT, REC_WINDOW_GEN = 2112, 4
XLSTM_TP_REPEATS = 2
# xlstm's --mesh 1,TP served runs: its paper/two_step served run was cut
# to pay for phase xattn (still held against paper/fused bit for bit
# before the served run)
XLSTM_TP_RUNS = TP_RUNS[:1]
# phase xattn: whisper-tiny (encoder-decoder: 4 enc + 4 dec blocks over
# 1500 frames) at full width and depth and llama-3.2-vision-11b (image
# cross-attention over 1600 patches) at full width, its 8 (xattn, dense x
# 4) repeats cut to VISION_REPEATS (2: 10 of 40 blocks, 2 of them xattn;
# then 1, 5 blocks, to pay for phase dp), tp = 1, served under
# XATTN_RUNS; whisper at --mesh 1,TP, full depth
WHISPER_ARCH = "whisper-tiny"
VISION_ARCH = "llama-3.2-vision-11b"
VISION_REPEATS = 1
XATTN_RUNS = (("paper/two_step", "paper", None), BASELINE)
# whisper at --mesh 1,TP: paper/fused served (fc_ar once a TP site, the
# encoder's included); paper/two_step held against it bit for bit only
XATTN_TP_RUNS = TP_RUNS[:1]
# phase kinds_train: the recurrent, sliding-window, encoder and
# cross-attention kinds trained at full width, arch -> its pattern repeats
# (None: its full depth): recurrentgemma-2b's (rec, rec, local) repeat and
# its (rec, rec) suffix (5 of 26 blocks: 1.60 B parameters at 16 B each of
# store, gradient and moments), xlstm-125m and whisper-tiny whole,
# llama-3.2-vision-11b's (xattn, dense x 4) repeat (5 of 40 blocks, 2.14 B
# parameters); bf16, paper through the CUDA codec and paper through the
# plain codec at --mesh 1,1, TRAIN_CHECK_STEPS steps each, then
# KINDS_TRAIN_MESHES (whisper-tiny) as rank processes
KINDS_TRAIN = (("recurrentgemma-2b", 1), ("xlstm-125m", None),
               ("whisper-tiny", None), ("llama-3.2-vision-11b", 1))
# xlstm's tokens a row: its mLSTM and sLSTM run a Python loop over the
# sequence, ~30 device operations a token and block (45,976 operations in
# a 4 x 128 prefill), replayed in the backward and differentiated, so
# TRAIN_SEQ would take ~4x as long as this; its widths stay whole
KINDS_XLSTM_SEQ = 128
# paper's step-0 loss against bf16's at --mesh 1,1, relative, per arch, on
# the H100
# (sound: 0, 1.5e-6, 1.6e-6 and 7.4e-6; with every value one code step of
# its row's range further from zero, a fault planted in a copy: 2.5e-5,
# 3.6e-5, 7.1e-5 and 3.9e-5; a constant step instead, which a LayerNorm
# removes: 3.0e-4, 3.5e-6, 1.8e-6 and 4.3e-4)
KINDS_LOSS_REL = {"recurrentgemma-2b": 1e-5, "xlstm-125m": 1e-5,
                  "whisper-tiny": 1e-5, "llama-3.2-vision-11b": 2e-5}
KINDS_TRAIN_MESHES = (("1,2", (("paper/two_step", "paper", None, None,
                                TRAIN_CHECK_STEPS),
                               ("paper/fused", "paper", "fused", None,
                                TRAIN_CHECK_STEPS))),)
#: the rank-process cells (phase_tp, tp_rank_main): tag -> (ranks, the
#: world checks (torch, axis, dev, configs) -> dict or None, the parts
#: served in turn, each (part, arch for _tp_cfg, runs, label, generated
#: tokens))
TP_CELLS = {
    "tp": (TP, lambda t, a, d, c: _tp_world_checks(t, a, d),
           (("dense", ARCH, DENSE_TP_RUNS, "tp", TP_GEN),
            ("moe", MOE_ARCH, MOE_TP_RUNS, "moe tp", TP_GEN))),
    "tp4": (GLM_TP, lambda t, a, d, c: _tp_world_checks(
        t, a, d, GLM_PROBE_CALLS, a2a=False),
            (("glm", GLM_ARCH, TP_RUNS, "tp4", TP_GEN),)),
    "ep8": (EP_TP, lambda t, a, d, c: _ep_world_checks(t, a, d, c[0]),
            (("ep", EP_ARCH, TP_RUNS, "ep8", EP_GEN),)),
    "rec_tp": (TP, None, (("xlstm", XLSTM_ARCH, XLSTM_TP_RUNS, "rec tp",
                           TP_GEN),)),
    "xattn_tp": (TP, None, (("whisper", WHISPER_ARCH, XATTN_TP_RUNS,
                             "xattn tp", TP_GEN),))}

# phase dp: data-parallel serving, qwen3-14b at full width, DP_LAYERS of
# its 40 layers (a float32 flat store of ~8.9 GB in all, sharded over the
# data axis), BATCH rows split over the replicas; every prefill and
# decode step gathers every block group over the data axis (gloo, host
# staged: the rank processes share the card), as the JAX package's does
DP_LAYERS = 2
DP_PROMPT = 2
# tokens generated a served run (2, then 1 to pay for phase kinds_train:
# a forward of --mesh 2,1 paper/two_step gathers 8.87 GB through host
# memory, ~15 s)
DP_GEN = 1
#: decode steps of each check (each step gathers the whole store; at most
#: DP_PROMPT: the check's steps are teacher-forced)
DP_CHECK_STEPS = 1
DP_TIMEOUT_S = 900
#: mesh -> (the check there, the runs served there); the checks: "alone"
#: (each replica's logits == its rows served alone at --mesh 1,1 from the
#: whole store, on the gather road at fsdp = 1: run in this process after
#: the ranks), "codec" (aggressive's qag: the CUDA codec == the plain
#: codec), "fused" (paper/fused == paper/two_step)
DP_CELLS = {"2,1": (("alone", "codec"),
                    (("paper/two_step", "paper", None),
                     ("aggressive/two_step", "aggressive", None))),
            "2,2": (("fused",), (("paper/fused", "paper", "fused"),))}
#: the windowed run of phase serve: qwen3-14b at tp = 1 with a window of
#: WINDOW on every block and a ring of WINDOW slots, PROMPT_LEN past it
#: (the ring wraps), served under bf16; the CUDA == plain check's decode
#: steps on a ring of WINDOW_CHECK slots, so that they wrap it too
WINDOW = 64
WINDOW_CHECK = DECODE_CHECK_STEPS // 2
# the windowed run's served prompt and generated tokens (PROMPT_LEN + GEN
# until cut to pay for phase kinds_train): past WINDOW, so that every
# ring wraps; the CUDA == plain check's prefill stays at PROMPT_LEN
WINDOW_PROMPT, WINDOW_GEN = WINDOW + 8, 4
TIME_CONFIGS = (("int8 g128", dict(bits=8, group=128)),
                ("int5 g128 scale_int", dict(bits=5, group=128,
                                             scale_int=True)),
                ("int2 g32 spike", dict(bits=2, group=32, spike=True)),
                ("int2 g32 rotation", dict(bits=2, group=32,
                                           rotation=True)))


def _path_time_rows(d: int, mcfg):
    """fc_decode_wire and fc_decode_reduce at the other shapes the serve
    paths give them, for ARCH's d_model d and MOE_ARCH's config mcfg:
    (shape label, config label, kernel, rows, n, out dtype, config).
    Moonshot's TP sites, (1, BATCH*PROMPT_LEN*dm) and (1, BATCH*dm); its
    dispatch receive, (experts x capacity, dm) bf16 rows at prefill and
    at decode; tp = 2's two_step rows, (2, n / 2) of ARCH's sites; a
    decode+reduce of 4 rows."""
    from repro_torch.models.moe import capacity
    int8, int4 = dict(bits=8, group=128), dict(bits=4, group=32)
    int4si = dict(bits=4, group=32, scale_int=True)
    prefill, decode, dm = BATCH * PROMPT_LEN, BATCH, mcfg.d_model
    rows = []
    for name in ("decode_wire", "decode_reduce"):
        rows += [("moe tp prefill", "int8 g128", name, 1, prefill * dm,
                  "float32", int8),
                 ("moe tp decode", "int8 g128", name, 1, decode * dm,
                  "float32", int8)]
    for shape, t in (("dispatch prefill", prefill), ("dispatch decode",
                                                     decode)):
        r = mcfg.moe.n_experts * capacity(t, mcfg)
        rows += [(shape, "int4 g32", "decode_wire", r, dm, "bfloat16", int4),
                 (shape, "int4 g32 scale_int", "decode_wire", r, dm,
                  "bfloat16", int4si)]
    return rows + [
        ("tp2 prefill", "int8 g128", "decode_wire", 2, prefill * d // 2,
         "float32", int8),
        ("tp2 decode", "int8 g128", "decode_wire", 2, decode * d // 2,
         "float32", int8),
        ("reduce R=4", "int8 g128", "decode_reduce", 4, prefill * d // 4,
         "float32", int8)]


# (label, kernel, bits, group, input dtype): the stage kernels' timing
# configs
STAGE_TIME = (("int8 g128", "quant_pack", 8, 128, "float32"),
              ("int8 g128", "dequant_unpack", 8, 128, "float32"),
              ("int4 g32", "quant_pack", 4, 32, "float32"),
              ("int4 g32", "dequant_unpack", 4, 32, "float32"),
              ("int2 g32 spike", "spike_pack", 2, 32, "float32"),
              ("int8 g128 bf16", "quant_pack", 8, 128, "bfloat16"),
              ("int4 g32 bf16", "quant_pack", 4, 32, "bfloat16"),
              ("int2 g32 spike bf16", "spike_pack", 2, 32, "bfloat16"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 1: card + build
# ---------------------------------------------------------------------------

def phase_build(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[build] card: {card}", flush=True)
    print(card, flush=True)
    from repro_torch.kernels import build, crc, rdma, stage, wire
    t0 = time.perf_counter()
    paths = build.build_all([wire.SOURCE, stage.SOURCE, rdma.SOURCE,
                             rdma.AR_SOURCE, crc.SOURCE], verbose=True)
    print(f"[build] {', '.join(p.name for p in paths)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wire._lib()
    stage._lib()
    rdma._lib()
    rdma._ar_lib()
    crc._lib()
    return card


# ---------------------------------------------------------------------------
# phase 2: codec against goldens and plain versions
# ---------------------------------------------------------------------------

def _bits_equal(torch, a, b) -> bool:
    """Bitwise equality of two same-dtype tensors (NaN-exact)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.uint8: torch.uint8,
            torch.int8: torch.int8}[a.dtype]
    return bool(torch.equal(a.view(view), b.view(view)))


def _edge_input(np, rows: int, n: int, seed: int):
    """Gaussian rows with outliers plus the codec's edge cases: a NaN
    group, a single-NaN group, a two-NaN group, inf, a constant group,
    duplicated extremes and signed zeros at a group's min or max."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 3).astype(np.float32)
    x[0, 5] = 45.0
    x[1, 70] = -38.0
    x[2, 0:128] = 1.25                       # constant groups
    x[2, 130] = x[2, 140] = 9.0              # duplicated max
    x[2, 150] = x[2, 160] = -9.0             # duplicated min
    x[3, 300] = np.nan                       # single NaN
    x[3, 520] = x[3, 530] = np.nan           # two NaNs in one group
    x[3, 700] = np.inf
    x[3, 800] = -np.inf
    # groups whose min or max is a zero of either sign (-0.0 orders below
    # +0.0, as in JAX)
    x[1, 256:288] = np.abs(x[1, 256:288])
    x[1, 260], x[1, 270] = -0.0, 0.0
    x[1, 320:352] = -np.abs(x[1, 320:352])
    x[1, 330], x[1, 340] = 0.0, -0.0
    x[2, 384:416] = 0.0
    x[2, 400] = -0.0
    return x


def _tie_input(np, rows: int, n: int, bits: int, group: int, spike: bool,
               seed: int):
    """Groups whose (v - z) / s is k + 1/2 exactly or one float32 ulp
    beside it, where a division that is not correctly rounded, or a wrong
    half-to-even, shows. Each group has a bf16 scale s (8 significant
    bits), its min z = j * s (j 0 or a power of two of either sign: a bf16
    zero) and its max z + qmax * s, so the codec's scale is s and its zero
    z exactly; every other value is z + (k + 1/2) s, a third of them one
    ulp down and a third one up. With spike two more values, below and
    above that range, take the spike slots. Positions are shuffled."""
    rng = np.random.default_rng(seed)
    qmax, groups = 2 ** bits - 1, rows * n // group
    s = rng.integers(128, 256, groups) * np.exp2(rng.integers(-14, -4, groups))
    z = rng.choice([0.0, 1.0, -1.0, 4.0, -16.0, 64.0], groups) * s
    x = z[:, None] + (rng.integers(0, qmax, (groups, group)) + 0.5) * s[:, None]
    x = x.astype(np.float32)
    step = rng.integers(-1, 2, x.shape)
    x = np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                 np.where(step > 0, np.nextafter(x, np.float32(np.inf)), x))
    x[:, 0], x[:, 1] = z, z + qmax * s
    if spike:
        x[:, 2], x[:, 3] = z - 2 * qmax * s, z + 3 * qmax * s
    return rng.permuted(x, axis=1).reshape(rows, n).astype(np.float32)


def phase_codec(torch, np):
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import wire
    dev = torch.device("cuda")
    data = np.load(GOLDEN)
    keys = [k for k in data.files if k.startswith(("int", "a2a_int"))]
    n_rot, rot_diff = 0, 0.0
    for key in keys:
        stem = key[len("a2a_"):] if key.startswith("a2a_") else key
        bits = int(stem.split("_")[0][len("int"):])
        cfg = CommConfig(bits=bits, group=32 if bits <= 4 else 128,
                         spike=stem.endswith("_sr"),
                         rotation=stem.endswith("_rot"))
        x = data["xa"] if key.startswith("a2a_") else data["x"]
        xt = torch.from_numpy(x.reshape(-1, x.shape[-1])).to(dev)
        buf = wire.encode_wire(xt, cfg)
        gold = torch.from_numpy(data[key].reshape(buf.shape)).to(dev)
        if cfg.rotation:
            # the goldens' rotation summed in XLA's order (see
            # tests/test_torch_codec.py::test_golden_encode_and_decode)
            check(torch.equal(buf, wire.encode_plain(xt, cfg)),
                  f"CUDA encode != plain {key}")
            frac = float((buf != gold).float().mean())
            check(frac <= 0.01, f"CUDA encode differs from golden {key} in "
                  f"{frac:.4f} of bytes > 0.01")
            n_rot, rot_diff = n_rot + 1, max(rot_diff, frac)
            cpu = wire.decode_plain(gold.cpu(), cfg, xt.shape[1])
            check(_bits_equal(torch, wire.decode_wire(
                gold, cfg, xt.shape[1]).cpu(), cpu),
                f"CUDA decode of golden {key} != plain decode on the CPU")
        else:
            check(torch.equal(buf, gold), f"CUDA encode != golden {key}")
        dec = wire.decode_wire(buf, cfg, xt.shape[1])
        ref = wire.decode_plain(buf, cfg, xt.shape[1])
        check(_bits_equal(torch, dec, ref), f"CUDA decode != plain {key}")
    print(f"[codec] {len(keys) - n_rot} raw golden keys byte-equal from the "
          f"CUDA encode, decode bit-equal to plain; {n_rot} _rot keys: CUDA "
          f"encode byte-equal to plain and within {rot_diff:.4f} <= 0.01 of "
          f"golden bytes, decode of the golden bit-equal to plain on the "
          f"card and on the CPU", flush=True)
    _frame_checks(torch, np, data)

    x = torch.from_numpy(_stage_input(np, 4, 1024, 7)).to(dev)
    cfgs = []
    for bits in (3, 8):
        for group in (32, 64, 128):
            for spike in (False, True):
                cfgs.append(CommConfig(bits=bits, group=group, spike=spike))
    for bits in range(1, 9):
        for group in (32, 64, 128):
            for spike in (False, True):
                cfgs.append(CommConfig(bits=bits, group=group, spike=spike,
                                       scale_int=True))
    for theta in (5, 20):
        for bits, group, spike in ((2, 32, True), (5, 128, False),
                                   (8, 128, False)):
            cfgs.append(CommConfig(bits=bits, group=group, spike=spike,
                                   scale_int=True, theta=theta))
    for bits, group, spike in ((2, 32, True), (3, 64, False),
                               (8, 128, False), (4, 32, True)):
        cfgs.append(CommConfig(bits=bits, group=group, spike=spike,
                               meta_dtype="float16"))
    n_rot = 0
    for bits in (2, 4, 8):
        for group in (32, 64, 128):
            cfgs.append(CommConfig(bits=bits, group=group, rotation=True))
            n_rot += 1
    for i, cfg in enumerate(cfgs):
        xt = torch.from_numpy(_tie_input(np, 4, 1024, cfg.bits, cfg.group,
                                         cfg.spike, 30 + i)).to(dev)
        check(torch.equal(wire.encode_wire(xt, cfg), wire.encode_plain(
            xt, cfg)), f"CUDA encode != plain for {cfg} on ties")
        buf = wire.encode_wire(x, cfg)
        check(torch.equal(buf, wire.encode_plain(x, cfg)),
              f"CUDA encode != plain for {cfg}")
        for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
            dec = wire.decode_wire(buf, cfg, x.shape[1], out_dtype)
            check(_bits_equal(torch, dec, wire.decode_plain(
                buf, cfg, x.shape[1], out_dtype)),
                f"CUDA decode != plain ({out_dtype}) for {cfg}")
        # all rows, and row 1 alone: its spike values hold -0.0, which
        # the sum from +0.0 makes +0.0
        for rows in (buf, buf[1:2].contiguous()):
            check(_bits_equal(torch, wire.decode_reduce(rows, cfg, x.shape[1]),
                              wire.decode_reduce_plain(rows, cfg, x.shape[1])),
                  f"CUDA decode_reduce != plain for {cfg} at {rows.shape[0]} "
                  f"rows")
    print(f"[codec] {len(cfgs)} plain / scale_int / theta / fp16-meta / "
          f"rotation ({n_rot}) configs with NaN (signed, with payloads), "
          f"inf, constant, signed-zero and duplicated-extreme groups: CUDA "
          f"encode byte-equal, decode (f32, bf16, fp16) and decode_reduce "
          f"bit-equal to plain; encode byte-equal on each config's tie "
          f"input", flush=True)

    rng = np.random.default_rng(11)
    xr = torch.from_numpy((rng.standard_normal((9, 4096)) * 2).astype(
        np.float32)).to(dev)
    for cfg in (CommConfig(bits=8, group=128),
                CommConfig(bits=5, group=128, scale_int=True),
                CommConfig(bits=2, group=32, spike=True),
                CommConfig(bits=2, group=32, rotation=True),
                CommConfig(bits=4, group=64, rotation=True),
                CommConfig(bits=8, group=128, rotation=True)):
        for rows in (1, 2, 8, 9):
            buf = wire.encode_wire(xr[:rows].contiguous(), cfg)
            red = wire.decode_reduce(buf, cfg, 4096)
            check(_bits_equal(torch, red, wire.decode_reduce_plain(
                buf, cfg, 4096)),
                f"CUDA decode_reduce != plain for {cfg} at ({rows}, 4096)")
    print("[codec] decode_reduce at (1 | 2 | 8 | 9, 4096): bit-equal to "
          "plain for int8, int5 scale_int, int2 spike and rotation int2 g32 "
          "/ int4 g64 / int8 g128", flush=True)

    # rows whose wire stride is no multiple of 8 (nor of 4 or 2): the
    # encode's plane and meta stores fall back to bytes where unaligned
    odd = []
    for kw in (dict(bits=8, group=32, scale_int=True),
               dict(bits=8, group=128), dict(bits=3, group=32, spike=True,
                                             scale_int=True),
               dict(bits=5, group=64, spike=True),
               dict(bits=7, group=128, rotation=True)):
        cfg = CommConfig(**kw)
        n = 3 * cfg.group
        xo = torch.from_numpy((rng.standard_normal((5, n)) * 2).astype(
            np.float32)).to(dev)
        buf = wire.encode_wire(xo, cfg)
        check(torch.equal(buf, wire.encode_plain(xo, cfg)),
              f"CUDA encode != plain for {cfg} at {tuple(xo.shape)}")
        check(_bits_equal(torch, wire.decode_wire(buf, cfg, n),
                          wire.decode_plain(buf, cfg, n)),
              f"CUDA decode != plain for {cfg} at {tuple(xo.shape)}")
        odd.append(buf.shape[1])
    print(f"[codec] rows of {odd} wire bytes: CUDA encode byte-equal and "
          f"decode bit-equal to plain", flush=True)


def _frame_golden_cfg(key: str):
    """The framed golden ``key``'s config (scripts/gen_golden_wire.py
    golden_cfg, framed)."""
    from repro_torch.core.comm_config import CommConfig
    stem = key[len("frame_"):]
    bits = int(stem.split("_")[0][len("int"):])
    return CommConfig(bits=bits, group=32 if bits <= 4 else 128,
                      spike=stem.endswith("_sr"),
                      rotation=stem.endswith("_rot"), framed=True)


def _crc_cases(torch):
    """(rows, length) of phase codec's fc_crc32c cases: L - 1, L and L + 1
    around a word, a bulk copy's 16 bytes, a chunk, a tile, the ring's
    tiles and a block's run of tiles (2 rows of SMs / 2 tiles: one tile a
    block, then two tiles in some blocks' runs, chains carried from tile to
    tile), and rows of 1 to 3 bytes, several rows a block, long runs."""
    from repro_torch.kernels import crc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = [(1, 1), (1, 2), (1, 3), (3, 1), (3, 2), (3, 3), (7, 1000),
           (5, 3 * crc.TILE + 16), (3, 60 * crc.TILE + 5),
           (2, 400 * crc.TILE + 16)]
    for rows, n in ((2, 4), (2, 16), (2, crc.CHUNK), (4, crc.TILE),
                    (3, crc.STAGES * crc.TILE), (2, sms // 2 * crc.TILE)):
        out += [(rows, n + d) for d in (-1, 0, 1)]
    return out


def _frame_checks(torch, np, data):
    """The framed wire on the card: the framed goldens through the CUDA
    codec, fc_crc32c against its plain version and the host CRC, and the
    decode's poisoning of every flipped byte."""
    from repro_torch.core import codec, frame
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import crc, wire
    dev = torch.device("cuda")
    keys = sorted(k for k in data.files if k.startswith("frame_"))
    check(len(keys) == 9, f"framed goldens: {keys}")
    x = torch.from_numpy(data["x"]).to(dev)
    n = x.shape[-1]
    before = dict(crc.LAUNCHES), dict(wire.LAUNCHES)
    for key in keys:
        cfg = _frame_golden_cfg(key)
        buf = codec.encode(x, cfg)
        gold = torch.from_numpy(data[key]).to(dev)
        check(torch.equal(buf, gold), f"CUDA framed encode != golden {key}")
        dec = codec.decode(gold, cfg, n)
        raw = codec.decode(codec.encode(x, cfg.with_framed(False)),
                           cfg.with_framed(False), n)
        check(_bits_equal(torch, dec, raw), f"CUDA framed decode of golden "
              f"{key} != the unframed decode")
        host = frame.frame_decode(data[key])
        check(host.shape == tuple(x.shape) and bool(torch.isfinite(
            host).all()), f"golden {key} does not self-describe on the host")
    check(crc.LAUNCHES["crc32c"] - before[0]["crc32c"] == 2 * len(keys) and
          wire.LAUNCHES["encode_wire"] - before[1]["encode_wire"]
          == 2 * len(keys), f"framed goldens: launches {crc.LAUNCHES} "
          f"{wire.LAUNCHES}")
    print(f"[codec] {len(keys)} framed goldens (frame_int*): CUDA encode "
          f"(fc_encode_wire + fc_crc32c) byte-equal, CUDA decode bit-equal "
          f"to the unframed decode, each self-describing on the host",
          flush=True)

    rng = np.random.default_rng(21)
    check(int(crc.crc32c_rows(torch.tensor([list(b"123456789")],
                                           dtype=torch.uint8, device=dev))[0])
          == 0xE3069283, "fc_crc32c of the check vector != 0xE3069283")
    n_cases, paths = 0, {True: 0, False: 0}
    for rows, length in _crc_cases(torch):
        # contiguous rows, framed rows' payloads (a pitch of 16 + length),
        # and rows 3 bytes into a pitch of 3 + length (never the ring)
        def rand(width):
            return torch.from_numpy(rng.integers(0, 256, (rows, width),
                                                 dtype=np.uint8)).to(dev)
        for view in (rand(length), rand(16 + length)[:, 16:],
                     rand(3 + length)[:, 3:]):
            ring = crc.ring_path(view.data_ptr(), view.stride(0)
                                 if rows > 1 else length, length)
            for init in (crc.MASK, 0x12345678):
                got = crc.crc32c_rows(view, init)
                check(torch.equal(got, crc.crc32c_rows_plain(view, init)),
                      f"fc_crc32c != plain at {tuple(view.shape)} stride "
                      f"{view.stride()} init {init:#x} "
                      f"({'ring' if ring else 'synchronous'} path)")
                if init == crc.MASK and length < 100000:
                    host = [frame.crc32c(r) for r in view.cpu().numpy()]
                    check(got.cpu().tolist() == host, f"fc_crc32c != host "
                          f"crc32c at {tuple(view.shape)}")
                n_cases += 1
                paths[ring] += 1
            del view
    check(paths[True] > 0 and paths[False] > 0, f"fc_crc32c paths: {paths}")
    leaf = _train_cfg()
    n_leaf = leaf.vocab * leaf.d_model // 2
    plen = CommConfig(bits=8, group=128).wire_bytes(n_leaf)
    big = torch.randint(0, 256, (2, plen), dtype=torch.uint8, device=dev)
    check(torch.equal(crc.crc32c_rows(big), crc.crc32c_rows_plain(big)),
          f"fc_crc32c != plain at the leaf-sized rows (2, {plen})")
    del big
    torch.cuda.empty_cache()
    print(f"[codec] fc_crc32c: the check vector 0xE3069283; {n_cases} "
          f"cases ({paths[True]} on the ring, {paths[False]} synchronous: "
          f"lengths L - 1, L, L + 1 around a word, 16 bytes, its "
          f"{crc.CHUNK}-byte chunk, its {crc.TILE}-byte tile, its ring of "
          f"{crc.STAGES} tiles and a run of tiles a block, up to 7 rows, "
          f"contiguous, odd-pitch and framed-payload rows, two initial "
          f"registers) equal to its plain version and (below 100000 bytes) "
          f"the host crc32c; equal to plain at the leaf-sized rows "
          f"(2, {plen}) (llama3-8b's embedding leaf at pod = 2, int8 g128 "
          f"wire)", flush=True)

    flips = 0
    for cfg in (CommConfig(bits=4, group=32, framed=True),
                CommConfig(bits=2, group=32, spike=True, scale_int=True,
                           framed=True),
                CommConfig(bits=8, group=128, rotation=True, framed=True)):
        m = 2 * cfg.group
        xs = torch.from_numpy((rng.standard_normal((3, m)) * 2).astype(
            np.float32)).to(dev)
        buf = codec.encode(xs, cfg)
        clean = codec.decode(buf, cfg, m)
        check(bool(torch.isfinite(clean).all()), f"framed decode of {cfg} "
              f"not finite")
        for i in range(buf.shape[1]):
            bad = buf.clone()
            bad[1, i] ^= 1 << (i % 8)
            out = codec.decode(bad, cfg, m)
            check(bool(torch.isnan(out[1]).all()) and _bits_equal(
                torch, out[0::2], clean[0::2]), f"flipped byte {i} of row 1 "
                f"({cfg}): not exactly that row poisoned")
            flips += 1
    print(f"[codec] {flips} single-bit flips, one in every byte of a framed "
          f"row (int4 g32, int2 g32 spike scale_int, int8 g128 rotation): "
          f"the CUDA decode NaN-poisons exactly that row, the other rows "
          f"bit-equal", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the per-stage kernels against their plain versions
# ---------------------------------------------------------------------------

def _stage_input(np, rows: int, n: int, seed: int):
    """The edge input, plus NaNs that carry a sign or a payload, each the
    only NaN of its group: the meta dtype must keep their bits as
    ``jnp.astype`` does."""
    x = _edge_input(np, rows, n, seed)
    bits = x.view(np.uint32)
    bits[1, 300] = 0xFFC00000                # negative NaN
    bits[1, 600] = 0x7FA12345                # NaN with a payload
    bits[0, 900] = 0xFFE54321                # both
    # zeros of both signs next to a group's min, then next to its max (the
    # shrunk range keeps -0.0, then +0.0)
    x[0, 448:480] = np.abs(x[0, 448:480]) + 1.0
    x[0, 450], x[0, 460], x[0, 470] = -7.0, 0.0, -0.0
    x[0, 480:512] = -np.abs(x[0, 480:512]) - 1.0
    x[0, 490], x[0, 500], x[0, 505] = 7.0, -0.0, 0.0
    return x


def _stage_inputs(torch, np, dev):
    from repro_torch.configs import get_config
    d_model = get_config(ARCH).d_model
    rng = np.random.default_rng(21)
    shapes = {"prefill": (1, BATCH * PROMPT_LEN * d_model),
              "decode": (1, BATCH * d_model), "bench": (64, 4096)}
    out = {k: torch.from_numpy((rng.standard_normal(v) * 3).astype(
        np.float32)).to(dev) for k, v in shapes.items()}
    out["edge"] = torch.from_numpy(_stage_input(np, 4, 1024, 9)).to(dev)
    return out


def _group_err_ok(torch, y, x, scale, group) -> bool:
    """Every finite value within two quantization steps of its group."""
    err = (y.float() - x.float()).abs().reshape(*scale.shape, group)
    step = scale.float()[..., None]
    return bool(torch.isfinite(y).all()) and bool((err <= 2 * step).all())


def phase_stage(torch, np):
    from repro_torch.kernels import (dequant_unpack, ops, quant_pack, ref,
                                     spike_reserve, stage)
    dev = torch.device("cuda")
    inputs = _stage_inputs(torch, np, dev)
    stage.reset_launches()
    want = dict.fromkeys(stage.LAUNCHES, 0)
    names = ("payload", "scale", "zero", "spike_vals", "spike_idx")
    for label, x32 in inputs.items():
        n = x32.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for bits, group in STAGE_SWEEP:
                got = quant_pack.quant_pack(x, bits, group)
                for name, a, b in zip(names, got, ref.quant_pack_ref(
                        x, bits, group)):
                    check(_bits_equal(torch, a, b), f"quant_pack {name} != "
                          f"plain: {label} {dtype} int{bits} g{group}")
                for out_dtype in (torch.float32, torch.bfloat16):
                    y = dequant_unpack.dequant_unpack(*got, bits, group, n,
                                                      out_dtype)
                    check(_bits_equal(torch, y, ref.dequant_unpack_ref(
                        *got, bits, group, n, out_dtype)),
                        f"dequant_unpack != plain: {label} {dtype} "
                        f"int{bits} g{group} -> {out_dtype}")
                want["quant_pack"] += 1
                want["dequant_unpack"] += 2
            for bits, group in STAGE_SPIKE:
                got = spike_reserve.spike_pack(x, bits, group)
                for name, a, b in zip(names, got, ref.spike_pack_ref(
                        x, bits, group)):
                    check(_bits_equal(torch, a, b), f"spike_pack {name} != "
                          f"plain: {label} {dtype} int{bits} g{group}")
                want["spike_pack"] += 1
    # ties: (v - z) / s on k + 1/2 or one ulp beside it, for each config
    packs = ((quant_pack.quant_pack, ref.quant_pack_ref, False, STAGE_SWEEP),
             (spike_reserve.spike_pack, ref.spike_pack_ref, True, STAGE_SPIKE))
    for pack, plain, spike, sweep in packs:
        for bits, group in sweep:
            x32 = torch.from_numpy(_tie_input(np, 8, 4096, bits, group, spike,
                                              40 + 10 * spike + bits)).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                for name, a, b in zip(names, pack(x, bits, group),
                                      plain(x, bits, group)):
                    check(_bits_equal(torch, a, b), f"{pack.__name__} {name} "
                          f"!= plain on ties: {dtype} int{bits} g{group}")
                want[pack.__name__] += 1
    # more rows than a grid's y dimension holds: blocks loop over rows
    x = torch.from_numpy((np.random.default_rng(23).standard_normal(
        (65536 + 3, 32)) * 3).astype(np.float32)).to(dev)
    for (pack, plain, _, _), bits in zip(packs, (4, 2)):
        for name, a, b in zip(names, pack(x, bits, 32), plain(x, bits, 32)):
            check(_bits_equal(torch, a, b), f"{pack.__name__} {name} != "
                  f"plain at {tuple(x.shape)}")
        want[pack.__name__] += 1
    got_launches = dict(stage.LAUNCHES)
    check(got_launches == want, f"stage launches {got_launches} != {want}")
    print(f"[stage] quant_pack, dequant_unpack (f32, bf16 out) and "
          f"spike_pack equal their plain versions byte for byte at "
          f"{', '.join(f'{k} {tuple(v.shape)}' for k, v in inputs.items())}"
          f", f32 and bf16 input, {len(STAGE_SWEEP)} + {len(STAGE_SPIKE)} "
          f"configs, and the packs on each config's tie input (8, 4096) and "
          f"at {tuple(x.shape)}; launches {got_launches} exact", flush=True)

    # the entry points, at the prefill site's shape
    x = inputs["prefill"]
    n = x.shape[1]
    stage.reset_launches()
    for bits, group in ((8, 128), (4, 32)):
        payload, scale, zero = ops.fused_quant_pack(x, bits, group)
        y = ops.fused_dequant_unpack(payload, scale, zero, bits, group, n)
        check(y.shape == x.shape and _group_err_ok(torch, y, x, scale,
                                                    group),
              f"fused quant_pack -> dequant_unpack int{bits} g{group}: "
              f"values off by more than two steps")
    outs = ops.fused_spike_pack(x, 2, 32)
    y = ref.spike_unpack_ref(*outs, 2, 32, n)
    check(_group_err_ok(torch, y, x, outs[1], 32),
          "fused spike_pack int2 g32: values off by more than two steps")
    launches = dict(stage.LAUNCHES)
    check(launches == {"quant_pack": 2, "dequant_unpack": 2,
                       "spike_pack": 1},
          f"entry points launched {launches}")
    print(f"[stage] entry points repro_torch.kernels.fused_quant_pack / "
          f"fused_dequant_unpack (int8 g128, int4 g32) and fused_spike_pack "
          f"(int2 g32) at (1, {n}): within two steps of the input; launches "
          f"{launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4: kernel times at the serving path's shapes
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, runs: int = 25, warmup: int = 5) -> float:
    """Median time of one call, CUDA events around each call: what a
    caller waits for, host-side launch work included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, runs: int = 25):
    """Device time of one call from torch.profiler (CUPTI) traces: each
    kernel's mean duration over the launches a trace of ``runs`` calls
    recorded, times its launches in a trace of one call, summed over the
    call's kernels -> (ms, kernel records in the long trace, records
    expected); None when no trace has device time. A long trace can lose
    kernel records (it then reads low as a sum over ``runs`` calls); the
    mean over the recorded launches does not depend on how many were
    lost."""
    from torch.profiler import ProfilerActivity, profile

    def trace(n: int) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t > 0 and ev.count:
                out[ev.key] = (t, ev.count)
        return out

    for _ in range(2):                   # a trace now and then comes back empty
        one, many = trace(1), trace(runs)
        if one and set(one) <= set(many):
            us = sum(many[k][0] / many[k][1] * c for k, (_, c) in one.items())
            return (us / 1e3, sum(c for _, c in many.values()),
                    runs * sum(c for _, c in one.values()))
    return None


def _max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over a kernel's outputs (one tensor or a tuple)."""
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    return max(float((x.float() - y.float()).abs().max()) for x, y in pairs)


def _time_row(torch, name, label, shape, kern, plain, nbytes, flops, card,
              runs: int = 25):
    """Time a kernel beside its plain version (``runs`` calls a timing);
    the row of the record."""
    err = _max_abs_err(torch, kern(), plain())
    call_ms, plain_call_ms = (_time_ms(torch, f, runs, min(5, runs))
                              for f in (kern, plain))
    dev, plain_dev = (_device_ms(torch, f, runs) for f in (kern, plain))
    dev_ms, plain_dev_ms = (d[0] if d else None for d in (dev, plain_dev))
    ms = dev_ms if dev_ms is not None else call_ms
    plain_ms = plain_dev_ms if plain_dev_ms is not None else plain_call_ms
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / F32_FLOPS_PER_S * 1e3
    bound, bound_by = max((byte_ms, "bytes"), (flop_ms, "operations"))
    src = (f"device, {dev[1]} of {dev[2]} kernel records" if dev
           else "no device trace: per call")
    psrc = "device" if plain_dev_ms is not None else \
        "no device trace: per call"
    print(f"[time] {name:14s} {label:18s} {shape}: kernel {ms:.4f} ms "
          f"({src}; {call_ms:.4f} ms per call)  plain {plain_ms:.4f} ms "
          f"({psrc}; {plain_call_ms:.4f} ms per call)  bound {bound:.6f} ms "
          f"({bound_by}; bytes {byte_ms:.6f}, f32 ops {flop_ms:.6f})  "
          f"max_abs_err {err}  [{card}]", flush=True)
    check(err == 0.0, f"{name} {label} {shape}: kernel differs from plain")
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "call_ms": call_ms,
            "plain_call_ms": plain_call_ms,
            "device_time": dev_ms is not None,
            "device_records": list(dev[1:]) if dev else None,
            "plain_device_time": plain_dev_ms is not None}


def phase_time(torch, np, card: str):
    """Rows keyed by (shape label, config label, kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import (dequant_unpack, quant_pack, ref,
                                     spike_reserve, stage, wire)
    dev = torch.device("cuda")
    d_model = get_config(ARCH).d_model
    rng = np.random.default_rng(3)
    rows = {}
    for shape, n in (("prefill", BATCH * PROMPT_LEN * d_model),
                     ("decode", BATCH * d_model)):
        x = torch.from_numpy(rng.standard_normal((1, n)).astype(
            np.float32)).to(dev)
        for label, kw in TIME_CONFIGS:
            cfg = CommConfig(**kw)
            buf = wire.encode_wire(x, cfg)
            fns = {
                "encode_wire": (lambda: wire.encode_wire(x, cfg),
                                lambda: wire.encode_plain(x, cfg)),
                "decode_wire": (lambda: wire.decode_wire(buf, cfg, n),
                                lambda: wire.decode_plain(buf, cfg, n)),
                "decode_reduce": (lambda: wire.decode_reduce(buf, cfg, n),
                                  lambda: wire.decode_reduce_plain(
                                      buf, cfg, n)),
            }
            for name, (kern, plain) in fns.items():
                rows.setdefault(shape, {}).setdefault(label, {})[name] = \
                    _time_row(torch, name, label, (1, n), kern, plain,
                              wire.bound_bytes(name, cfg, 1, n),
                              wire.bound_flops(name, cfg, 1, n), card)
        for label, name, bits, group, dtype in STAGE_TIME:
            xs = x.to(getattr(torch, dtype))
            packed = quant_pack.quant_pack(xs, bits, group)
            kern, plain = {
                "quant_pack": (
                    lambda: quant_pack.quant_pack(xs, bits, group),
                    lambda: ref.quant_pack_ref(xs, bits, group)),
                "dequant_unpack": (
                    lambda: dequant_unpack.dequant_unpack(*packed, bits,
                                                          group, n),
                    lambda: ref.dequant_unpack_ref(*packed, bits, group, n)),
                "spike_pack": (
                    lambda: spike_reserve.spike_pack(xs, bits, group),
                    lambda: ref.spike_pack_ref(xs, bits, group)),
            }[name]
            rows.setdefault(shape, {}).setdefault(label, {})[name] = \
                _time_row(torch, name, label, (1, n), kern, plain,
                          stage.bound_bytes(name, bits, group, 1, n,
                                            xs.element_size()), 0, card)
    for shape, label, name, r, n, out, kw in _path_time_rows(
            d_model, get_config(MOE_ARCH)):
        cfg = CommConfig(**kw)
        out_dtype = getattr(torch, out)
        x = torch.from_numpy(rng.standard_normal((r, n)).astype(
            np.float32)).to(dev)
        buf = wire.encode_wire(x, cfg)
        if name == "decode_wire":
            kern = lambda: wire.decode_wire(buf, cfg, n, out_dtype)
            plain = lambda: wire.decode_plain(buf, cfg, n, out_dtype)
        else:
            kern = lambda: wire.decode_reduce(buf, cfg, n)
            plain = lambda: wire.decode_reduce_plain(buf, cfg, n)
        rows.setdefault(shape, {}).setdefault(label, {})[name] = _time_row(
            torch, name, label, (r, n), kern, plain,
            wire.bound_bytes(name, cfg, r, n, out_dtype.itemsize),
            wire.bound_flops(name, cfg, r, n), card)
    return rows


# ---------------------------------------------------------------------------
# phase 5: serve qwen3-14b at full width
# ---------------------------------------------------------------------------

def _fill_output_projections(torch, cfg, plan, params, seed: int,
                             rank: int = 0):
    """Fill the zero-initialised output projections (attention, MLP,
    experts and the recurrent mixers') of every block from a fan-in
    normal (std 1/sqrt(fan_in)), one stack slice at a time, so that every
    TP and dispatch site of every layer carries data and every expert's
    output is non-zero. In a model with recurrent blocks the zero
    vectors sharded over TP (RG-LRU's gate weights and biases and its
    conv bias, sLSTM's gate biases) are filled from a standard normal
    too, so that the gates depend on the data; in a model with biases
    (``use_bias``) every zero vector (the projections' biases and the
    LayerNorm biases) from a normal of std BIAS_STD; other zero vectors
    stay zero. A TP rank ``rank`` folds its index into the seed of the
    tensors sliced over TP, so that the ranks' shards differ; a
    replicated tensor draws from a generator of its own, the same on
    every rank."""
    from repro_torch.models.model import param_groups
    vectors = bool(set(cfg.layer_kinds) & {"rec", "mlstm", "slstm"})
    names = [(g, n, sp.tp_dim is None and sp.moe_fold is None)
             for g, (_, specs) in sorted(param_groups(cfg, plan).items())
             for n, sp in specs.items()
             if sp.init == "zeros" and (len(sp.shape) > 1 or cfg.use_bias
                                        or (vectors
                                            and sp.tp_dim is not None))]
    t0 = params[names[0][0]][names[0][1]]
    gen = torch.Generator(device=t0.device)
    gen.manual_seed(seed + 1000003 * rank)
    rgen = torch.Generator(device=t0.device)
    rgen.manual_seed(seed + 2000003)
    for g, name, replicated in names:
        t = params[g][name]
        std = (t.shape[-2] ** -0.5 if t.dim() > 2
               else BIAS_STD if cfg.use_bias else 1.0)
        for i in range(t.shape[0]):         # one float32 slice at a time
            t[i].copy_(torch.randn(t.shape[1:], generator=rgen if replicated
                                   else gen, device=t.device).mul_(std))
    return [f"{g}/{n}" for g, n, _ in names]


def phase_serve(torch, np):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import stage, wire
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import forward
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step, make_prefill)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")

    # reference on a small input: the smoke config's prefill gives the
    # same logits through the CUDA codec as through the plain one
    scfg = get_smoke_config(ARCH)
    splan = make_plan(scfg, tp=1)
    sparams = init_params(scfg, splan, 1, dev)
    _fill_output_projections(torch, scfg, splan, sparams, 2)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, scfg.vocab, (2, 64))).to(dev)
    for name in ("paper", "aggressive"):
        a, b = (make_prefill(scfg, splan, build_policy(name, backend=be))(
            sparams, toks) for be in ("cuda", "ref"))
        check(_bits_equal(torch, a, b), f"smoke prefill {name}: logits "
              f"through the CUDA codec differ from the plain codec's")
    print("[serve] smoke config: prefill logits through the CUDA codec "
          "equal the plain codec's (paper, aggressive)", flush=True)
    del sparams

    cfg = get_config(ARCH)
    plan = make_plan(cfg, tp=1)
    t0 = time.perf_counter()
    params = init_params(cfg, plan, SEED, dev, torch.bfloat16)
    filled = _fill_output_projections(torch, cfg, plan, params, SEED + 1)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for g in params.values()
                 for t in g.values())
    print(f"[serve] {ARCH} full width, {cfg.n_layers} layers: "
          f"{nbytes / 1e9:.2f} GB bf16 weights from seed {SEED} ({filled} "
          f"filled) in {time.perf_counter() - t0:.1f} s", flush=True)

    # The codec on the card with data at every site, at both of the
    # path's shapes: the CUDA kernels against the plain codec, on the same
    # weights, inputs and (for decode) caches, bit for bit.
    prompts = torch.from_numpy(make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=PROMPT_LEN, global_batch=BATCH,
        seed=SEED)).batch(0)["tokens"]).to(dev)
    for label, pol, scheme in RUNS:
        pols = [build_policy(pol, backend=b, scheme=scheme)
                for b in ("cuda", "ref")]
        h_cuda, h_plain = (forward(params, prompts, cfg, plan, p,
                                   dtype=torch.bfloat16)[0] for p in pols)
        check(_bits_equal(torch, h_cuda, h_plain),
              f"full-width prefill {label}: hidden states through the CUDA "
              f"codec differ from the plain codec's")
        steps = [make_decode_step(cfg, plan, p) for p in pols]
        caches = [make_cache_init(cfg, plan, BATCH, DECODE_CHECK_STEPS,
                                  dev)() for _ in pols]
        for i in range(DECODE_CHECK_STEPS):
            (lc, caches[0]), (lr, caches[1]) = (
                st(params, c, prompts[:, i:i + 1])
                for st, c in zip(steps, caches))
            check(_bits_equal(torch, lc, lr),
                  f"full-width decode {label} step {i}: logits through the "
                  f"CUDA codec differ from the plain codec's")
            check(torch.equal(lc.argmax(-1), lr.argmax(-1)),
                  f"full-width decode {label} step {i}: tokens differ")
        del caches
    print(f"[serve] full width: prefill hidden states and "
          f"{DECODE_CHECK_STEPS} decode steps' logits and tokens through "
          f"the CUDA codec equal the plain codec's bit for bit "
          f"({', '.join(r[0] for r in RUNS)})", flush=True)

    sites = 1 + 2 * cfg.n_layers           # embedding + attn/MLP per layer
    forwards = 1 + PROMPT_LEN + GEN - 1
    wire.reset_launches()                  # the main path starts here
    stage.reset_launches()
    results = {}
    for label, pol, scheme in SERVE_RUNS + (BASELINE,):
        before = dict(wire.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        res = serve(params, cfg, plan, build_policy(pol, scheme=scheme),
                    batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN, device=dev,
                    seed=SEED, label=f" {label}")
        got = {k: wire.LAUNCHES[k] - before[k] for k in wire.LAUNCHES}
        per_site = {"encode_wire": 2,
                    "decode_wire": 1 if scheme == "fused" else 2,
                    "decode_reduce": 1 if scheme == "fused" else 0}
        want = {k: 0 if label == BASELINE[0] else v * sites * forwards
                for k, v in per_site.items()}
        print(f"[serve {label}] launches {got} (expected {want}); peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        check(got == want, f"{label}: launches {got} != {want}")
        check(res["agreement"] is not None,
              f"{label}: no prefill/decode check")
        results[label] = res
    launches = dict(wire.LAUNCHES)         # read right after the main path
    stage_launches = dict(stage.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} never launched on the main path")
    check(set(stage_launches.values()) == {0},
          f"stage kernels launched on the serve path: {stage_launches}")
    launches.update(stage_launches)
    rel = max(results[BASELINE[0]]["agreement"]["rel_divergence"])
    check(rel <= CACHE_REL_TOL, f"unquantized prefill/decode logit "
          f"divergence {rel} > {CACHE_REL_TOL}: KV-cache drift")
    print(f"[serve] unquantized prefill/decode logit divergence {rel} <= "
          f"{CACHE_REL_TOL}", flush=True)
    check(np.array_equal(results["paper/two_step"]["generated"],
                         results["paper/fused"]["generated"]),
          "fused and two_step generated different tokens")
    print("[serve] paper/fused generated the same tokens as "
          "paper/two_step", flush=True)
    results["window"] = _serve_window(torch, cfg, plan, params, prompts, dev)
    return launches, results


def _serve_window(torch, cfg, plan, params, prompts, dev) -> dict:
    """window_override on qwen3-14b at tp = 1 (every block windowed, none
    of them local): the prefill's hidden states with a window of WINDOW
    over the PROMPT_LEN prompt, and DECODE_CHECK_STEPS decode steps'
    logits on a ring of WINDOW_CHECK slots with that window (so that
    they wrap it), through the CUDA codec equal the plain codec's bit
    for bit (paper); then BATCH x WINDOW_PROMPT + WINDOW_GEN tokens
    served under bf16 with a window and a ring of WINDOW slots (the
    prompt wraps it):
    prefill/decode agreement to CACHE_REL_TOL, every ring holding the
    last WINDOW positions."""
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import forward
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    pols = [build_policy("paper", backend=b) for b in ("cuda", "ref")]
    h = [forward(params, prompts, cfg, plan, p, dtype=torch.bfloat16,
                 window_override=WINDOW)[0] for p in pols]
    check(_bits_equal(torch, *h), "windowed prefill: hidden states through "
          "the CUDA codec differ from the plain codec's")
    del h
    steps = [make_decode_step(cfg, plan, p, window_override=WINDOW_CHECK)
             for p in pols]
    caches = [make_cache_init(cfg, plan, BATCH, WINDOW_CHECK, dev)()
              for _ in pols]
    for i in range(DECODE_CHECK_STEPS):
        (lc, caches[0]), (lr, caches[1]) = (
            st(params, c, prompts[:, i:i + 1])
            for st, c in zip(steps, caches))
        check(_bits_equal(torch, lc, lr), f"windowed decode step {i} (a "
              f"ring of {WINDOW_CHECK} slots): logits through the CUDA "
              f"codec differ from the plain codec's")
    del caches
    print(f"[serve window] prefill hidden states (window {WINDOW} over "
          f"{PROMPT_LEN} positions) and {DECODE_CHECK_STEPS} decode steps' "
          f"logits (window and ring of {WINDOW_CHECK}, wrapped) through the "
          f"CUDA codec equal the plain codec's bit for bit (paper)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    res = serve(params, cfg, plan, build_policy("bf16"),
                batch=BATCH, prompt_len=WINDOW_PROMPT, gen=WINDOW_GEN,
                device=dev, seed=SEED, label=f" window {WINDOW} bf16",
                window_override=WINDOW, cache_len=WINDOW, keep_caches=True)
    caches = res.pop("caches")
    last = WINDOW_PROMPT + WINDOW_GEN - 2
    for layer in caches["layers"]:
        got = sorted(layer["slot_pos"].tolist())
        check(got == list(range(last - WINDOW + 1, last + 1)),
              f"windowed ring: slots {got[:3]}... hold other positions "
              f"than the last {WINDOW}")
    rel = max(res["agreement"]["rel_divergence"])
    check(rel <= CACHE_REL_TOL, f"windowed bf16 prefill/decode logit "
          f"divergence {rel} > {CACHE_REL_TOL}")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve window {WINDOW} bf16] {cfg.name}: TTFT "
          f"{res['ttft_ms']:.1f} ms, decode median "
          f"{res['step_ms_median']:.2f} ms/step, p90 "
          f"{res['step_ms_p90']:.2f}; every ring ({len(caches['layers'])}) "
          f"holds positions {last - WINDOW + 1}..{last}; prefill/decode "
          f"logit divergence {rel:.4f} <= {CACHE_REL_TOL}; peak memory "
          f"{res['peak_gb']:.2f} GB", flush=True)
    return res


def phase_ln(torch, np):
    """command-r-35b (LayerNorm) at tp = 1 at full width, its depth cut to
    LN_REPEATS: paper/two_step's prefill hidden states and
    DECODE_CHECK_STEPS decode steps' logits through the CUDA codec equal
    the plain codec's bit for bit; then LN_RUNS served with exact
    launches, every norm a LayerNorm (counted), and prefill/decode
    agreement (the run without the codec to CACHE_REL_TOL)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import stage, wire
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models import layers
    from repro_torch.models.model import forward
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()                   # the earlier models are gone
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LN_ARCH), pattern_repeats=LN_REPEATS)
    check(cfg.norm == "ln", f"{LN_ARCH}: norm {cfg.norm}")
    plan = make_plan(cfg, tp=1)
    t0 = time.perf_counter()
    params = init_params(cfg, plan, SEED, dev, torch.bfloat16)
    filled = _fill_output_projections(torch, cfg, plan, params, SEED + 1)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for g in params.values()
                 for t in g.values())
    print(f"[ln] {LN_ARCH} full width, {cfg.n_layers} of its 40 layers: "
          f"{nbytes / 1e9:.2f} GB bf16 weights from seed {SEED} ({filled} "
          f"filled) in {time.perf_counter() - t0:.1f} s", flush=True)

    prompts = torch.from_numpy(make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=PROMPT_LEN, global_batch=BATCH,
        seed=SEED)).batch(0)["tokens"]).to(dev)
    label, pol, scheme = LN_RUNS[0]
    pols = [build_policy(pol, backend=b, scheme=scheme)
            for b in ("cuda", "ref")]
    h_cuda, h_plain = (forward(params, prompts, cfg, plan, p,
                               dtype=torch.bfloat16)[0] for p in pols)
    check(bool(torch.isfinite(h_cuda).all()),
          f"ln prefill {label}: hidden states not finite")
    check(_bits_equal(torch, h_cuda, h_plain), f"ln prefill {label}: hidden "
          f"states through the CUDA codec differ from the plain codec's")
    steps = [make_decode_step(cfg, plan, p) for p in pols]
    caches = [make_cache_init(cfg, plan, BATCH, DECODE_CHECK_STEPS, dev)()
              for _ in pols]
    for i in range(DECODE_CHECK_STEPS):
        (lc, caches[0]), (lr, caches[1]) = (
            st(params, c, prompts[:, i:i + 1])
            for st, c in zip(steps, caches))
        check(_bits_equal(torch, lc, lr), f"ln decode {label} step {i}: "
              f"logits through the CUDA codec differ from the plain codec's")
    del caches, h_cuda, h_plain
    print(f"[ln] full width: prefill hidden states and {DECODE_CHECK_STEPS} "
          f"decode steps' logits through the CUDA codec equal the plain "
          f"codec's bit for bit ({label})", flush=True)

    norms = [0]
    plain_ln = layers.layer_norm

    def counted(*a, **k):
        norms[0] += 1
        return plain_ln(*a, **k)

    sites = 1 + 2 * cfg.n_layers
    forwards = 1 + PROMPT_LEN + GEN - 1
    layers.layer_norm = counted
    try:
        wire.reset_launches()              # the ln path starts here
        stage.reset_launches()
        results = {}
        for label, pol, scheme in LN_RUNS:
            before, n0 = dict(wire.LAUNCHES), norms[0]
            torch.cuda.reset_peak_memory_stats()
            res = serve(params, cfg, plan, build_policy(pol, scheme=scheme),
                        batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN,
                        device=dev, seed=SEED, label=f" ln {label}")
            got = {k: wire.LAUNCHES[k] - before[k] for k in wire.LAUNCHES}
            want = {"encode_wire": 2, "decode_wire": 2, "decode_reduce": 0}
            want = {k: 0 if pol == "bf16" else v * sites * forwards
                    for k, v in want.items()}
            n_norms = norms[0] - n0
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"[ln {label}] launches {got} (expected {want}); "
                  f"LayerNorms {n_norms} (expected "
                  f"{(2 * cfg.n_layers + 1) * forwards}); peak memory "
                  f"{peak:.2f} GB", flush=True)
            check(got == want, f"ln {label}: launches {got} != {want}")
            check(n_norms == (2 * cfg.n_layers + 1) * forwards,
                  f"ln {label}: {n_norms} LayerNorms")
            check(res["agreement"] is not None,
                  f"ln {label}: no prefill/decode check")
            res["peak_gb"] = peak
            results[label] = res
        launches = dict(wire.LAUNCHES)     # read right after the ln path
        stage_launches = dict(stage.LAUNCHES)
    finally:
        layers.layer_norm = plain_ln
    for k, v in launches.items():
        check(v > 0 or k == "decode_reduce",
              f"kernel {k} never launched on the ln path")
    check(set(stage_launches.values()) == {0},
          f"stage kernels launched on the ln path: {stage_launches}")
    rel = max(results[BASELINE[0]]["agreement"]["rel_divergence"])
    check(rel <= CACHE_REL_TOL, f"ln: unquantized prefill/decode logit "
          f"divergence {rel} > {CACHE_REL_TOL}: KV-cache drift")
    print(f"[ln] unquantized prefill/decode logit divergence {rel} <= "
          f"{CACHE_REL_TOL}", flush=True)
    return launches, results


# ---------------------------------------------------------------------------
# phase 6: the peer-push All2All in a loopback world
# ---------------------------------------------------------------------------

def _a2a_rows(tp: int):
    """Rows a rank sends each peer at moonshot's dispatch with ep = tp:
    (E / tp) experts of capacity(tokens) slots, at prefill and decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config(MOE_ARCH)
    e_loc = cfg.moe.n_experts // tp
    return (cfg.d_model,
            {"prefill": e_loc * capacity(BATCH * PROMPT_LEN, cfg),
             "decode": e_loc * capacity(BATCH, cfg)})


def _a2a_payload(torch, gen, tp: int, m: int, d: int, dev,
                 dtype=None):
    x = torch.randn((tp, tp, m, d), generator=gen, device=dev) * 2
    x[:, :, 0, 5] = 40.0                       # an outlier in every block
    return x.to(dtype or torch.bfloat16)


def _a2a_blocks_and_out(world, fn):
    """Run one fc_a2a call -> (its output, its blocks a rank: what the
    call added to the world's local-slot target)."""
    before = world.targets[A2A_COLLECTIVE][2]
    out = fn()
    return out, world.targets[A2A_COLLECTIVE][2] - before


def phase_a2a(torch, card: str):
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import ops, rdma
    from repro_torch.kernels.protocol import all2all_protocol
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    rdma.reset_launches()                       # the a2a path starts here
    want = 0
    for tp in A2A_TPS:
        d, rows = _a2a_rows(tp)
        wb_max = max(CommConfig(**kw).wire_bytes(d) for _, kw in A2A_CONFIGS)
        world = rdma.PeerWorld.loopback(
            tp, rows["prefill"] * wb_max, dev,
            protocols=(all2all_protocol(tp),))
        # the dispatch payload is bf16; f32 (the kernel's other payload
        # type) for the paper config at the smallest world
        runs = [(label, kw, torch.bfloat16) for label, kw in A2A_CONFIGS]
        if tp == A2A_TPS[0]:
            runs.append((A2A_CONFIGS[0][0] + " f32", A2A_CONFIGS[0][1],
                         torch.float32))
        # each shape, then the two alternating: the grid changes from
        # call to call
        sizes = [(shape, [m] * A2A_CALLS) for shape, m in rows.items()]
        sizes.append(("alternating", [list(rows.values())[i % 2]
                                      for i in range(A2A_CALLS)]))
        blocks = {}
        for label, kw, dtype in runs:
            cfg = CommConfig(**kw)
            for shape, ms in sizes:
                xs = [_a2a_payload(torch, gen, tp, m, d, dev, dtype)
                      for m in ms]
                outs, grid = zip(*(_a2a_blocks_and_out(
                    world, lambda x=x: ops.fused_all_to_all(
                        x, cfg, world)) for x in xs))   # back to back, no sync
                want += len(xs)
                torch.cuda.synchronize()
                for i, (x, out) in enumerate(zip(xs, outs)):
                    ref, recv = rdma.fused_all_to_all_rdma_plain(x, cfg)
                    check(_bits_equal(torch, out, ref),
                          f"a2a tp={tp} {label} {shape} call {i}: output "
                          f"differs from the plain version's")
                wb = cfg.wire_bytes(d)
                for r in range(tp):
                    check(torch.equal(world.recv_rows(r)[:, :ms[-1] * wb],
                                      recv[r]),
                          f"a2a tp={tp} {label} {shape}: rank {r}'s receive "
                          f"buffer differs from the plain version's")
                blocks.setdefault(label, {})[shape] = sorted(set(grid))
                del xs, outs
        pads = [world.signal_pad(r).tolist() for r in range(tp)]
        for r in range(tp):
            check(pads[r] == world.pad_targets(A2A_COLLECTIVE),
                  f"a2a tp={tp}: rank {r}'s signal pad {pads[r]} after "
                  f"{world.epochs[A2A_COLLECTIVE]} calls, targets "
                  f"{world.pad_targets(A2A_COLLECTIVE)}")
        print(f"[a2a] tp={tp} (rows a peer: {rows}, d {d}; blocks a rank "
              f"{blocks}): {[r[0] for r in runs]} x ({len(rows)} shapes + "
              f"alternating shapes) x {A2A_CALLS} back-to-back calls, "
              f"outputs bit-equal and last receive buffers byte-equal to "
              f"the plain version; epoch {world.epochs[A2A_COLLECTIVE]}, "
              f"signal pads at their targets {pads[0]}", flush=True)
        del world
    launches = dict(rdma.LAUNCHES)              # read right after the path
    check(launches == {"a2a": want, "ar": 0},
          f"a2a launches {launches} != {want}")
    print(f"[a2a] launches {launches} exact (one a call)", flush=True)

    # time at tp = A2A_TIME_TP and at the serve path's tp = TP, both
    # shapes, paper int4 g32; the spike config at tp = A2A_TIME_TP
    timed = {}
    for tp, (label, kw) in ((A2A_TIME_TP, A2A_CONFIGS[0]),
                            (A2A_TIME_TP, A2A_CONFIGS[2]),
                            (TP, A2A_CONFIGS[0])):
        cfg = CommConfig(**kw)
        d, rows = _a2a_rows(tp)
        world = rdma.PeerWorld.loopback(
            tp, rows["prefill"] * cfg.wire_bytes(d), dev,
            protocols=(all2all_protocol(tp),))
        for shape, m in rows.items():
            x = _a2a_payload(torch, gen, tp, m, d, dev)
            row = _time_row(
                torch, "a2a", label, tuple(x.shape),
                lambda: rdma.fused_all_to_all_rdma(x, cfg, world),
                lambda: rdma.fused_all_to_all_rdma_plain(x, cfg)[0],
                rdma.bound_bytes(cfg, tp, m, d, x.element_size()), 0, card)
            row["blocks"] = _a2a_blocks_and_out(
                world, lambda: rdma.fused_all_to_all_rdma(x, cfg, world))[1]
            print(f"[a2a] tp={tp} {label} {shape}: {row['blocks']} blocks a "
                  f"rank", flush=True)
            key = shape if label == A2A_CONFIGS[0][0] else f"{shape} {label}"
            timed.setdefault(tp, {})[key] = row
        del world
    print(f"[a2a] bound: all ranks' bytes (payload read, wire written and "
          f"read, output written) over {HBM_BYTES_PER_S / 1e12} TB/s: "
          f"device memory time on one card, not link time", flush=True)
    return launches, timed


# ---------------------------------------------------------------------------
# phase 7: serve moonshot-v1-16b-a3b at full width
# ---------------------------------------------------------------------------

def phase_moe(torch, np):
    import dataclasses
    from repro_torch.configs import get_config
    torch.cuda.empty_cache()                   # the dense model is gone
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              pattern_repeats=MOE_REPEATS)
    return _serve_tp1(torch, np, cfg, SERVE_RUNS + (BASELINE,), "moe",
                      checks=MOE_CHECK_ONLY)


def phase_moe_archs(torch, np, card: str):
    """grok-1 and llama4-maverick at full width, tp = 1, their depth cut
    to MOE_ARCHS' (_serve_tp1 under MOE_ARCH_RUNS, one model at a time)
    -> (the launches of both paths, {arch: served results})."""
    import dataclasses
    from repro_torch.configs import get_config
    launches, served = {}, {}
    for arch, repeats in MOE_ARCHS:
        torch.cuda.empty_cache()               # the earlier models are gone
        cfg = dataclasses.replace(get_config(arch), pattern_repeats=repeats)
        got, served[arch] = _serve_tp1(torch, np, cfg, MOE_ARCH_RUNS,
                                       "moe_archs", card)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches, served


def _serve_inputs(torch, cfg, dev):
    """The served prompts (BATCH, PROMPT_LEN) from the data stream of
    seed SEED, and, for a model with an encoder or cross-attention, the
    stub frontend's embeddings (BATCH, n_ctx, d_model) drawn after them
    (None otherwise), on ``dev``: what ``serve`` gives the model."""
    from repro_torch.train.data import DataConfig, make_dataset
    enc = cfg.encoder.n_ctx if (cfg.is_enc_dec or cfg.has_cross) else None
    batch = make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=PROMPT_LEN, global_batch=BATCH, seed=SEED,
        enc_ctx=enc, d_model=cfg.d_model)).batch(0)
    return (torch.from_numpy(batch["tokens"]).to(dev),
            torch.from_numpy(batch["enc_embeds"]).to(dev) if enc else None)


def _tp_sites(cfg) -> int:
    """TP sites a forward: the embedding's, and a block's mixer's and
    MLP's (an moe block's attention only: at tp = 1 its experts' sum
    crosses no rank; an mlstm or slstm block has no MLP; a dec block's
    self-attention, cross-attention and MLP), and an encoder's 2 a block
    (the encoder runs in every forward, a decode step's too)."""
    enc = 2 * cfg.encoder.n_layers if cfg.is_enc_dec else 0
    return 1 + enc + sum(
        3 if k == "dec" else
        2 if k in ("dense", "local", "rec", "enc", "xattn") else 1
        for k in cfg.layer_kinds)


def _serve_tp1(torch, np, cfg, runs, tag: str, card: str = "",
               census: bool = False, checks=()):
    """Model ``cfg`` at full width on one card (weights from seed SEED,
    the zero-initialised output projections, attention, MLP, experts and
    the recurrent mixers', filled): for each quantized run of ``checks``
    and ``runs`` the prefill's hidden states and DECODE_CHECK_STEPS decode steps' logits
    through the CUDA kernels equal those through the plain codec, bit for
    bit; then it serves BATCH x PROMPT_LEN + GEN tokens under ``runs``
    with exact launch counts (a TP site: 2 encodes, 2 decodes, fused 1
    decode and 1 decode+reduce; a dispatch: 1 of each) and prints TTFT,
    ms/step, peak memory, and an MoE model's routes dropped over capacity
    or another's prefill/decode agreement (the run without the codec to
    CACHE_REL_TOL); with ``census``, then _census on the same
    weights -> (launches over the served runs, {label: served result,
    "census": _census's result}). A model with an encoder or
    cross-attention is given the stream's embeddings (_serve_inputs) in
    every forward."""
    from repro_torch.kernels import rdma, stage, wire
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import forward
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    plan = make_plan(cfg, tp=1)
    t0 = time.perf_counter()
    params = init_params(cfg, plan, SEED, dev, torch.bfloat16)
    filled = _fill_output_projections(torch, cfg, plan, params, SEED + 1)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for g in params.values()
                 for t in g.values())
    kinds = cfg.layer_kinds
    moe = cfg.moe is not None
    blocks = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    if cfg.encoder is not None:
        blocks += (f"; {cfg.encoder.n_layers} enc blocks, "
                   f"{cfg.encoder.n_ctx} encoder positions")
    if moe:
        blocks += (f"; {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
                   f"{cfg.act}")
    print(f"[{tag}] {cfg.name} full width, {cfg.n_layers} layers "
          f"({blocks}): {nbytes / 1e9:.2f} GB bf16 weights from seed "
          f"{SEED} ({filled} filled) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    prompts, embeds = _serve_inputs(torch, cfg, dev)
    checked = [r for r in checks + runs if r[1] != "bf16"]
    for label, pol, scheme in checked:
        pols = [build_policy(pol, backend=b, scheme=scheme)
                for b in ("cuda", "ref")]
        h_cuda, h_plain = (forward(params, prompts, cfg, plan, p,
                                   dtype=torch.bfloat16,
                                   enc_embeds=embeds)[0] for p in pols)
        check(bool(torch.isfinite(h_cuda).all()),
              f"{tag} prefill {label}: hidden states not finite")
        check(_bits_equal(torch, h_cuda, h_plain),
              f"{tag} prefill {label}: hidden states through the CUDA codec "
              f"differ from the plain codec's")
        steps = [make_decode_step(cfg, plan, p) for p in pols]
        caches = [make_cache_init(cfg, plan, BATCH, DECODE_CHECK_STEPS,
                                  dev)() for _ in pols]
        for i in range(DECODE_CHECK_STEPS):
            (lc, caches[0]), (lr, caches[1]) = (
                st(params, c, prompts[:, i:i + 1], embeds)
                for st, c in zip(steps, caches))
            check(_bits_equal(torch, lc, lr),
                  f"{tag} decode {label} step {i}: logits through the CUDA "
                  f"codec differ from the plain codec's")
        del caches, h_cuda, h_plain
    print(f"[{tag}] {cfg.name} full width: prefill hidden states and "
          f"{DECODE_CHECK_STEPS} decode steps' logits through the CUDA "
          f"codec equal the plain codec's bit for bit "
          f"({', '.join(r[0] for r in checked)})", flush=True)

    tp_sites = _tp_sites(cfg)
    a2a_sites = kinds.count("moe")
    forwards = 1 + PROMPT_LEN + GEN - 1
    wire.reset_launches()                  # the path starts here
    stage.reset_launches()
    rdma.reset_launches()
    results, expected = {}, dict.fromkeys(wire.LAUNCHES, 0)
    for label, pol, scheme in runs:
        before = dict(wire.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        res = serve(params, cfg, plan, build_policy(pol, scheme=scheme),
                    batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN, device=dev,
                    seed=SEED, label=f" {tag} {label}")
        got = {k: wire.LAUNCHES[k] - before[k] for k in wire.LAUNCHES}
        fused = scheme == "fused"
        # a TP site: 2 encodes, 2 decodes (fused: 1 decode + 1
        # decode_reduce); a dispatch site: 1 encode, 1 decode
        per_fwd = {"encode_wire": 2 * tp_sites + a2a_sites,
                   "decode_wire": (1 if fused else 2) * tp_sites + a2a_sites,
                   "decode_reduce": tp_sites if fused else 0}
        want = {k: 0 if pol == "bf16" else v * forwards
                for k, v in per_fwd.items()}
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        extra = (f"routes dropped prefill {res['dropped_prefill']} of "
                 f"{res['routes_prefill']}, decode {res['dropped_decode']} "
                 f"of {res['routes_decode']}" if moe else
                 f"prefill/decode logit divergence "
                 f"{max(res['agreement']['rel_divergence']):.4f}")
        print(f"[{tag} {label}] {cfg.name}: launches {got} (expected "
              f"{want}; {tp_sites} TP and {a2a_sites} dispatch sites a "
              f"forward, {forwards} forwards); TTFT {res['ttft_ms']:.1f} ms, "
              f"decode median {res['step_ms_median']:.2f} ms/step, p90 "
              f"{res['step_ms_p90']:.2f}; {extra}; peak memory "
              f"{res['peak_gb']:.2f} GB" + (f"  [{card}]" if card else ""),
              flush=True)
        check(got == want, f"{tag} {label}: launches {got} != {want}")
        check((res["agreement"] is None) == moe,
              f"{tag} {label}: prefill/decode check {res['agreement']}")
        if pol == "bf16" and not moe:
            rel = max(res["agreement"]["rel_divergence"])
            check(rel <= CACHE_REL_TOL, f"{tag} {cfg.name}: unquantized "
                  f"prefill/decode logit divergence {rel} > "
                  f"{CACHE_REL_TOL}: cache drift")
        for k, v in want.items():
            expected[k] += v
        results[label] = res
    launches = dict(wire.LAUNCHES)         # read right after the path
    stage_launches = dict(stage.LAUNCHES)
    for k, v in launches.items():
        check(v > 0 or expected[k] == 0,
              f"kernel {k} never launched on the {tag} path")
    check(set(stage_launches.values()) == {0} and rdma.LAUNCHES["a2a"] == 0,
          f"stage or a2a kernels launched on the {tag} path: "
          f"{stage_launches} {rdma.LAUNCHES}")
    if "paper/fused" in results:
        check(np.array_equal(results["paper/two_step"]["generated"],
                             results["paper/fused"]["generated"]),
              f"{tag}: fused and two_step generated different tokens")
        print(f"[{tag}] paper/fused generated the same tokens as "
              f"paper/two_step", flush=True)
    if census:
        results["census"] = _census(torch, cfg, plan, params, prompts,
                                    embeds, tag, card)
    del params
    return launches, results


# ---------------------------------------------------------------------------
# phase 8: the fused AllReduce's phase kernels in loopback worlds
# ---------------------------------------------------------------------------

def _ar_shapes():
    """n per rank at qwen3-14b's TP sites: the prefill's B*S*d_model and
    the decode step's B*d_model."""
    from repro_torch.configs import get_config
    d = get_config(ARCH).d_model
    return {"prefill": BATCH * PROMPT_LEN * d, "decode": BATCH * d}


def _ar_input(torch, gen, tp: int, n: int, dev):
    """Every rank's vector, (tp, n) f32, an outlier in each."""
    x = torch.randn((tp, n), generator=gen, device=dev) * 2
    x[:, 5] = 40.0
    return x


def _ar_pads_ok(world, rank: int) -> bool:
    """Rank ``rank``'s two AllReduce pads hold exactly the world's running
    targets: the scatter barrier every peer's signals of every call, the
    gather barrier none (fc_ar runs only the scatter phase's barrier),
    each receive slot and the local slot what every call's blocks
    added."""
    return all(world.signal_pad(rank, cid).tolist() == world.pad_targets(cid)
               for cid in (AR_SCATTER, AR_GATHER))


def _ar_check_calls(torch, world, cfg, xs, outs, what: str) -> None:
    """Each output of back-to-back calls bit-equal to the plain version's,
    and the last call's receive rows of both phases byte-equal."""
    from repro_torch.kernels import rdma
    torch.cuda.synchronize()
    tp = world.tp
    for i, (x, out) in enumerate(zip(xs, outs)):
        ref, scat, gath = rdma.fused_all_reduce_rdma_plain(x, cfg)
        check(_bits_equal(torch, out, ref),
              f"ar tp={tp} {what} call {i}: output differs from the plain "
              f"version's")
    wb = cfg.wire_bytes(xs[-1].shape[1] // tp)
    for r in range(tp):
        for cid, plain in ((AR_SCATTER, scat), (AR_GATHER, gath)):
            check(torch.equal(world.recv_rows(r, cid)[:, :wb], plain[r]),
                  f"ar tp={tp} {what}: rank {r}'s receive rows of protocol "
                  f"{cid} differ from the plain version's")


def _ar_steps(torch, world, x, cfg, calls: int = 25) -> dict:
    """Where an fc_ar call's time goes: the kernel's stamps (the card's
    clock at each step boundary, as block 0 of every rank sees it) over
    ``calls`` back-to-back calls; each step's median over the calls, then
    the mean over the ranks, in us."""
    from repro_torch.kernels import rdma
    st = torch.zeros((calls, world.local_ranks, len(rdma.AR_STAMPS)),
                     dtype=torch.int64, device=x.device)
    for i in range(calls):
        rdma.fused_all_reduce_rdma(x, cfg, world, stamps=st[i])
    torch.cuda.synchronize()
    d = torch.cat([st[:, :, 1:] - st[:, :, :-1],
                   st[:, :, -1:] - st[:, :, :1]], dim=2).double() / 1e3
    med = d.median(dim=0).values.mean(dim=0)
    return dict(zip(rdma.AR_STAMPS[1:] + ("total",),
                    (round(float(v), 3) for v in med)))


def phase_ar(torch, card: str):
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import ops, rdma
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    shapes = _ar_shapes()
    rdma.reset_launches()                       # the ar path starts here
    want = 0
    for tp in AR_TPS:
        row = max(CommConfig(**kw).wire_bytes(n // tp)
                  for n in shapes.values() for _, kw in AR_CONFIGS)
        world = rdma.PeerWorld.loopback(tp, row, dev,
                                        protocols=rdma.ar_protocols(tp))
        for label, kw in AR_CONFIGS:
            cfg = CommConfig(**kw)
            for shape, n in shapes.items():
                xs = [_ar_input(torch, gen, tp, n, dev)
                      for _ in range(AR_CALLS)]
                outs = [ops.fused_all_reduce(x, cfg, world)
                        for x in xs]            # back to back, no sync
                want += AR_CALLS
                _ar_check_calls(torch, world, cfg, xs, outs,
                                f"{label} {shape}")
                del xs, outs
            # the grid changes from call to call: shapes alternate
            xs = [_ar_input(torch, gen, tp, list(shapes.values())[i % 2],
                            dev) for i in range(AR_CALLS)]
            outs = [ops.fused_all_reduce(x, cfg, world) for x in xs]
            want += AR_CALLS
            _ar_check_calls(torch, world, cfg, xs, outs, f"{label} mixed")
            del xs, outs
        for r in range(tp):
            pads = [world.signal_pad(r, c).tolist()
                    for c in (AR_SCATTER, AR_GATHER)]
            check(_ar_pads_ok(world, r), f"ar tp={tp}: rank {r}'s signal "
                  f"pads {pads} after {world.epochs} calls, targets "
                  f"{[world.pad_targets(c) for c in (AR_SCATTER, AR_GATHER)]}")
        blocks = {label: {k: world.ar_blocks(n, CommConfig(**kw))
                          for k, n in shapes.items()}
                  for label, kw in AR_CONFIGS}
        print(f"[ar] tp={tp} (n {shapes}, blocks a rank {blocks}, caps "
              f"{world.caps}): "
              f"{[c[0] for c in AR_CONFIGS]} "
              f"x ({len(shapes)} shapes + alternating shapes) x "
              f"{AR_CALLS} back-to-back calls, outputs bit-equal and last "
              f"receive rows of both phases byte-equal to the plain version; "
              f"epochs {world.epochs}, pads of rank 0 at their targets "
              f"{[world.pad_targets(c) for c in (AR_SCATTER, AR_GATHER)]}",
              flush=True)
        del world
    launches = dict(rdma.LAUNCHES)              # read right after the path
    check(launches == {"a2a": 0, "ar": want},
          f"ar launches {launches} != {want}")
    print(f"[ar] launches {launches} exact (one a call)", flush=True)

    # time at tp = AR_TIME_TP, both shapes, the paper's int8 g128 (with
    # step times) and the spike config
    tp = AR_TIME_TP
    cfg = CommConfig(**AR_CONFIGS[0][1])
    world = rdma.PeerWorld.loopback(
        tp, cfg.wire_bytes(shapes["prefill"] // tp), dev,
        protocols=rdma.ar_protocols(tp))
    timed = {}
    for label, kw in (AR_CONFIGS[0], AR_CONFIGS[2]):
        cfg = CommConfig(**kw)
        for shape, n in shapes.items():
            x = _ar_input(torch, gen, tp, n, dev)
            row = _time_row(
                torch, "ar", label, tuple(x.shape),
                lambda: rdma.fused_all_reduce_rdma(x, cfg, world),
                lambda: rdma.fused_all_reduce_rdma_plain(x, cfg)[0],
                tp * rdma.bound_bytes_ar(cfg, tp, n), 0, card)
            row["blocks"] = world.ar_blocks(n, cfg)
            if label != AR_CONFIGS[0][0]:
                timed[f"{shape} {label}"] = row
                continue
            row["steps_us"] = _ar_steps(torch, world, x, cfg)
            print(f"[ar] {shape}: {row['blocks']} blocks a rank; step times "
                  f"(us, block 0, median of 25 calls, mean over ranks) "
                  f"{row['steps_us']}  [{card}]", flush=True)
            timed[shape] = row
    print(f"[ar] bound: all {tp} ranks' bytes (input read, wire written and "
          f"read in both phases, output written) over "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: device memory time on one card, "
          f"not link time", flush=True)
    return launches, timed


# ---------------------------------------------------------------------------
# phase 9: qwen3-14b at --mesh 1,TP, one rank a process
# ---------------------------------------------------------------------------

def _timed_calls(torch, axis, calls):
    """Run ``calls`` back to back after a host barrier of the ranks of
    ``axis``, no sync between them -> (outputs, ms of each call)."""
    from repro_torch.launch import mesh
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(calls) + 1)]
    mesh.barrier(axis)
    ev[0].record()
    outs = []
    for i, call in enumerate(calls):
        outs.append(call())
        ev[i + 1].record()
    torch.cuda.synchronize()
    return outs, [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def _a2a_world_probe(torch, axis, gen, d: int, rows: dict, dev) -> tuple:
    """fc_a2a (the paper config) through the peer world of ``axis`` at
    each shape of ``rows`` ({shape: rows a peer} of ``d`` values, bf16):
    A2A_CALLS calls back to back, timed between the processes, each
    bit-equal to the plain version of every rank's input -> ({shape: ms
    of each call}, {shape: blocks a call})."""
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import ops, rdma
    world, rank, tp = axis.world, axis.rank, axis.size
    acfg = CommConfig(**A2A_CONFIGS[0][1])
    a2a_ms, a2a_blocks = {}, {}
    for shape, m in rows.items():
        xa = [_a2a_payload(torch, gen, tp, m, d, dev)
              for _ in range(A2A_CALLS)]
        mine = [x[rank:rank + 1].contiguous() for x in xa]
        outs, a2a_ms[shape] = _timed_calls(torch, axis, [
            lambda x=x: ops.fused_all_to_all(x, acfg, world) for x in mine])
        for i, (x, out) in enumerate(zip(xa, outs)):
            ref, _ = rdma.fused_all_to_all_rdma_plain(x, acfg)
            check(_bits_equal(torch, out[0], ref[rank]),
                  f"rank {rank} of {tp}: fc_a2a {shape} call {i} through "
                  f"the world of processes differs from the plain version")
        a2a_blocks[shape] = world.a2a_blocks(m, d, acfg, torch.bfloat16)
        del xa, mine, outs
    return a2a_ms, a2a_blocks


def _tp_world_checks(torch, axis, dev, probe_calls: int = TP_PROBE_CALLS,
                     a2a: bool = True) -> dict:
    """fc_ar (``probe_calls`` calls) and, with ``a2a``, fc_a2a through this
    rank's world of processes. Every rank draws every rank's inputs from
    one seed, so it can run the plain version of all ranks and hold its
    own slice to it bit for bit."""
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import ops, rdma
    world, rank, tp = axis.world, axis.rank, axis.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)

    n = _ar_shapes()["decode"]
    cfg = CommConfig(**AR_CONFIGS[0][1])
    xs = [_ar_input(torch, gen, tp, n, dev) for _ in range(probe_calls)]
    outs, per_call = _timed_calls(torch, axis, [
        lambda x=x: ops.fused_all_reduce(x[rank], cfg, world) for x in xs])
    for i, (x, out) in enumerate(zip(xs, outs)):
        ref, scat, gath = rdma.fused_all_reduce_rdma_plain(x, cfg)
        check(_bits_equal(torch, out, ref[rank]),
              f"tp rank {rank}: fc_ar call {i} through the world of "
              f"processes differs from the plain version")
    wb = cfg.wire_bytes(n // tp)
    check(torch.equal(world.recv_rows(rank, AR_SCATTER)[:, :wb], scat[rank])
          and torch.equal(world.recv_rows(rank, AR_GATHER)[:, :wb],
                          gath[rank]),
          f"tp rank {rank}: fc_ar's receive rows differ from the plain "
          f"version's")
    if not a2a:
        check(_ar_pads_ok(world, rank),
              f"tp rank {rank}: signal pads off after {world.epochs} calls")
        return {"ar_n": n, "ar_calls": probe_calls, "epochs": world.epochs,
                "caps": {str(k): v for k, v in world.caps.items()},
                "ar_blocks": world.ar_blocks(n, cfg), "probe_ms": per_call}

    # fc_a2a at moonshot's dispatch with ep = tp, its prefill and decode
    # rows: A2A_CALLS back to back at each, timed between the processes
    d, rows = _a2a_rows(tp)
    acfg = CommConfig(**A2A_CONFIGS[0][1])
    a2a_ms, a2a_blocks = _a2a_world_probe(torch, axis, gen, d, rows, dev)
    # then fc_a2a (decode rows) and fc_ar alternating: each protocol
    # counts its own calls on its own pad
    for i in range(A2A_CALLS):
        xa = _a2a_payload(torch, gen, tp, rows["decode"], d, dev)
        out = ops.fused_all_to_all(xa[rank:rank + 1].contiguous(), acfg,
                                   world)
        ref, _ = rdma.fused_all_to_all_rdma_plain(xa, acfg)
        check(_bits_equal(torch, out[0], ref[rank]),
              f"tp rank {rank}: fc_a2a call {i} after fc_ar differs from "
              f"the plain version")
        x = _ar_input(torch, gen, tp, n, dev)
        out = ops.fused_all_reduce(x[rank], cfg, world)
        check(_bits_equal(torch, out,
                          rdma.fused_all_reduce_rdma_plain(x, cfg)[0][rank]),
              f"tp rank {rank}: fc_ar after fc_a2a call {i} differs")
    torch.cuda.synchronize()
    check(_ar_pads_ok(world, rank) and _a2a_pads_ok(world, rank),
          f"tp rank {rank}: signal pads off after {world.epochs} calls")
    return {"ar_n": n, "ar_calls": probe_calls + A2A_CALLS,
            "a2a_rows": rows, "a2a_calls": len(rows) * A2A_CALLS + A2A_CALLS,
            "epochs": world.epochs,
            "caps": {str(k): v for k, v in world.caps.items()},
            "ar_blocks": world.ar_blocks(n, cfg), "a2a_blocks": a2a_blocks,
            "probe_ms": per_call, "a2a_ms": a2a_ms}


def _a2a_pads_ok(world, rank: int) -> bool:
    """Rank ``rank``'s All2All pad holds exactly the world's running
    targets."""
    return (world.signal_pad(rank, A2A_COLLECTIVE).tolist()
            == world.pad_targets(A2A_COLLECTIVE))


def _ep_world_checks(torch, axis, dev, cfg) -> dict:
    """Phase ep8's peer worlds, each with its own ranks: fc_ar
    (EP_PROBE_CALLS calls at the decode probe's n) through the model
    world of EP_TP processes and through this rank's etp world, then
    fc_a2a through its ep world at ``cfg``'s dispatch rows (prefill and
    decode), each call timed between the processes, bit-equal to the
    plain versions, the pads exact."""
    from repro_torch.models.moe import capacity
    out = {name: _tp_world_checks(torch, sub, dev, EP_PROBE_CALLS,
                                  a2a=False)
           for name, sub in (("model", axis), ("etp", axis.etp))}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    ep = axis.ep
    e_loc = cfg.moe.n_experts // ep.size
    rows = {"prefill": e_loc * capacity(BATCH * PROMPT_LEN, cfg),
            "decode": e_loc * capacity(BATCH, cfg)}
    a2a_ms, blocks = _a2a_world_probe(torch, ep, gen, cfg.d_model, rows, dev)
    torch.cuda.synchronize()
    check(_a2a_pads_ok(ep.world, ep.rank), f"ep8 rank {axis.rank}: the ep "
          f"world's All2All pad off after {ep.world.epochs} calls")
    out["ep"] = {"a2a_rows": rows, "a2a_blocks": blocks, "a2a_ms": a2a_ms,
                 "epochs": ep.world.epochs}
    for name, sub in (("model", axis), ("etp", axis.etp), ("ep", ep)):
        out[name]["group"] = torch.distributed.get_process_group_ranks(
            sub.pg)
        out[name]["row_bytes"] = sub.world.row_bytes
    return out


def _world_calls(axis) -> dict:
    """The fc_ar and fc_a2a calls so far of each peer world of the model
    axis ``axis``: its own and, with ep and etp subaxes, theirs."""
    subs = {"model": axis}
    if axis.ep is not None:
        subs.update(ep=axis.ep, etp=axis.etp)
    return {f"{name} {kernel}": sub.world.epochs.get(cid, 0)
            for name, sub in subs.items()
            for kernel, cid in (("fc_ar", AR_SCATTER),
                                ("fc_a2a", A2A_COLLECTIVE))}


def _tp_counts():
    from repro_torch.kernels import rdma, stage, wire
    return {**wire.LAUNCHES, **stage.LAUNCHES, **rdma.LAUNCHES}


def _tp_serve(torch, axis, dev, cfg, runs, tag: str, gen: int) -> dict:
    """Model ``cfg`` on this rank of the model axis ``axis`` (tp = its
    size): weights from SEED (output projections filled), paper/fused ==
    paper/two_step bit for bit (the prefill's hidden states,
    DECODE_CHECK_STEPS decode steps' logits), then the served ``runs``
    (TP_PROMPT prompt tokens, ``gen`` generated) with exact counts:
    fused, every TP site
    and every within-expert AllReduce (etp > 1) through fc_ar and every
    dispatch through fc_a2a, no wire kernel; two_step, two encodes and
    two decodes a TP site or within-expert AllReduce (around the gloo
    hop), one of each a dispatch site; bf16, none. In replicate mode the
    decode's ring merges (``attention.RING_MERGES``) number one an
    attention layer and decode step."""
    from repro_torch.kernels import rdma, stage, wire
    from repro_torch.launch import mesh
    from repro_torch.models import attention
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import forward
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    rank, tp = axis.rank, axis.size
    log = print if rank == 0 else (lambda *a, **k: None)
    moe = cfg.moe is not None
    plan = make_plan(cfg, tp=tp)
    t0 = time.perf_counter()
    params = init_params(cfg, plan, SEED, dev, torch.bfloat16, rank=rank)
    filled = _fill_output_projections(torch, cfg, plan, params, SEED + 1,
                                      rank)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for g in params.values()
                 for t in g.values())
    experts = (f" (ep {plan.moe.ep} x etp {plan.moe.etp}, {plan.moe.e_loc} "
               f"experts a rank)" if moe else "")
    width = "smoke config" if cfg.name.endswith("-smoke") else "full width"
    kv = (f", {cfg.n_kv_heads} kv heads {plan.kv_mode}d"
          if plan.kv_mode == "replicate" else "")
    log(f"[{tag}] {cfg.name} {width} at --mesh 1,{tp}, {cfg.n_layers} "
        f"layers{experts}{kv}: "
        f"{nbytes / 1e9:.2f} GB bf16 weights a rank from seed {SEED} "
        f"({filled} filled) in {time.perf_counter() - t0:.1f} s",
        flush=True)

    # paper/fused (the peer-push kernels) against paper/two_step (the
    # wire kernels around the gloo hop), bit for bit on this rank
    prompts, embeds = _serve_inputs(torch, cfg, dev)
    pols = [build_policy("paper", scheme=s) for s in ("fused", "two_step")]
    mesh.barrier(axis)
    hf, ht = (forward(params, prompts, cfg, plan, p, dtype=torch.bfloat16,
                      group=axis, enc_embeds=embeds)[0] for p in pols)
    check(bool(torch.isfinite(hf).all()),
          f"{tag} rank {rank}: prefill hidden states not finite")
    check(_bits_equal(torch, hf, ht), f"{tag} rank {rank}: prefill hidden "
          f"states under paper/fused differ from paper/two_step")
    steps = [make_decode_step(cfg, plan, p, group=axis) for p in pols]
    clen = -(-DECODE_CHECK_STEPS // tp) * tp      # the ring: a tp multiple
    caches = [make_cache_init(cfg, plan, BATCH, clen, dev)() for _ in pols]
    for i in range(DECODE_CHECK_STEPS):
        (lf, caches[0]), (lt, caches[1]) = (
            st(params, c, prompts[:, i:i + 1], embeds)
            for st, c in zip(steps, caches))
        check(_bits_equal(torch, lf, lt), f"{tag} rank {rank}: decode step "
              f"{i} logits under paper/fused differ from paper/two_step")
    del caches, hf, ht
    log(f"[{tag}] every rank: prefill hidden states and {DECODE_CHECK_STEPS} "
        f"decode steps' logits under paper/fused (fc_ar"
        f"{', fc_a2a' if moe else ''}) equal paper/two_step's bit for bit",
        flush=True)

    kinds = cfg.layer_kinds
    tp_sites = _tp_sites(cfg)
    a2a_sites = kinds.count("moe")
    etp_sites = a2a_sites if moe and plan.moe.etp > 1 else 0
    forwards = 1 + TP_PROMPT + gen - 1
    merges = (sum(k in ("dense", "local", "moe", "dec") for k in kinds)
              * (TP_PROMPT + gen - 1) if plan.kv_mode == "replicate" else 0)
    wire.reset_launches()                  # the tp path starts here
    stage.reset_launches()
    rdma.reset_launches()
    served, peaks = {}, {}
    for label, pol, scheme in runs:
        before = _tp_counts()
        calls0 = _world_calls(axis)
        attention.reset_ring_merges()
        torch.cuda.reset_peak_memory_stats()
        res = serve(params, cfg, plan, build_policy(pol, scheme=scheme),
                    batch=BATCH, prompt_len=TP_PROMPT, gen=gen, device=dev,
                    seed=SEED, label=f" {tag}={tp} {label}", log=log,
                    group=axis)
        got = {k: v - before[k] for k, v in _tp_counts().items()}
        check(attention.RING_MERGES == merges,
              f"{tag} rank {rank} {label}: {attention.RING_MERGES} ring "
              f"merges != {merges}")
        res["ring_merges"] = attention.RING_MERGES
        want = dict.fromkeys(got, 0)
        if scheme == "fused":
            want["ar"] = (tp_sites + etp_sites) * forwards
            want["a2a"] = a2a_sites * forwards
        elif pol != "bf16":
            want["encode_wire"] = want["decode_wire"] = \
                (2 * (tp_sites + etp_sites) + a2a_sites) * forwards
        # the calls of each peer world: with ep and etp subaxes the
        # dispatch crosses the ep world and the within-expert AllReduce
        # the etp world
        calls = {k: v - calls0[k] for k, v in _world_calls(axis).items()}
        want_calls = dict.fromkeys(calls, 0)
        if scheme == "fused":
            sub = axis.ep is not None
            want_calls["model fc_ar"] = (tp_sites + (0 if sub else etp_sites)
                                         ) * forwards
            want_calls["ep fc_a2a" if sub else "model fc_a2a"] = \
                a2a_sites * forwards
            if sub:
                want_calls["etp fc_ar"] = etp_sites * forwards
        res["world_calls"] = calls
        peaks[label] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[{tag} {label}] rank {rank} launches {got} (expected: "
            f"{tp_sites} TP, {etp_sites} within-expert AllReduce and "
            f"{a2a_sites} dispatch sites x {forwards} forwards); calls a "
            f"peer world { {k: v for k, v in calls.items() if v} }; ring "
            f"merges {attention.RING_MERGES} (expected {merges})",
            flush=True)
        check(got == want, f"{tag} rank {rank} {label}: launches {got} != "
              f"{want}")
        check(calls == want_calls, f"{tag} rank {rank} {label}: calls a "
              f"peer world {calls} != {want_calls}")
        check((res["agreement"] is None) == moe,
              f"{tag} {label}: prefill/decode check {res['agreement']}")
        served[label] = res
    launches = _tp_counts()                # read right after the tp path
    for k in ("ar", "a2a") if moe else ("ar",):
        check(launches[k] > 0, f"{k} never launched on the {tag} path")
    if "paper/two_step" in served:
        a, b = served["paper/fused"], served["paper/two_step"]
        check(bool((a["generated"] == b["generated"]).all()),
              f"{tag} rank {rank}: fused and two_step generated different "
              f"tokens")
        check(all(a[k] == b[k] for k in a if k.startswith("dropped")),
              f"{tag} rank {rank}: fused and two_step dropped different "
              f"routes")
    return {"arch": cfg.name, "launches": launches, "peak_gb": peaks,
            "layers": cfg.n_layers, "runs": {
        k: {m: (v.tolist() if hasattr(v, "tolist") else v)
            for m, v in r.items()} for k, r in served.items()}}


def _tp_cfg(arch: str):
    """The rank-process cells' configs (TP_CELLS): at full width, their
    depth cut, qwen3-14b to TP_REPEATS layers, moonshot to its dense
    block and TP_MOE_REPEATS MoE blocks, glm4-9b to GLM_REPEATS layers,
    xlstm-125m to XLSTM_TP_REPEATS (mlstm, slstm) repeats; EP_ARCH at its
    smoke config; whisper-tiny at full depth."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    if arch == EP_ARCH:
        return get_smoke_config(arch)
    if arch == WHISPER_ARCH:
        return get_config(arch)
    repeats = {ARCH: TP_REPEATS, MOE_ARCH: TP_MOE_REPEATS,
               GLM_ARCH: GLM_REPEATS, XLSTM_ARCH: XLSTM_TP_REPEATS}[arch]
    return dataclasses.replace(get_config(arch), pattern_repeats=repeats)


def tp_rank_main(rank: int, tag: str, rendezvous: str, out_dir: str) -> int:
    """One rank process (``chip_smoke.py --tp-rank``) of the cell ``tag``
    of TP_CELLS: its world checks, if it has them, then its parts served
    in turn, each part's weights freed before the next (the mesh has the
    first part's ep and etp subaxes, if it has experts)."""
    import torch
    from repro_torch.launch import mesh
    from repro_torch.parallel.plan import make_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    size, world_checks, parts = TP_CELLS[tag]
    dev = mesh.rank_device(rank, torch.device("cuda"))
    cfgs = [_tp_cfg(arch) for _, arch, _, _, _ in parts]
    plans = [make_plan(cfg, tp=size) for cfg in cfgs]
    row_bytes = max(mesh.site_row_bytes(cfg, plan, BATCH, PROMPT_LEN)
                    for cfg, plan in zip(cfgs, plans))
    axes = mesh.init_mesh(1, size, 0, rank, rendezvous, dev, row_bytes,
                          plans[0].moe)
    axis = axes.model
    try:
        res = {"rank": rank, "device": str(dev),
               "row_bytes": row_bytes.model,
               "backend": str(torch.distributed.get_backend(axis.pg))}
        if world_checks is not None:
            res["world"] = world_checks(torch, axis, dev, cfgs)
        for (part, _, runs, label, gen), cfg in zip(parts, cfgs):
            torch.cuda.empty_cache()           # the earlier part is gone
            res[part] = _tp_serve(torch, axis, dev, cfg, runs, label, gen)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        mesh.close_mesh(axes)
    return 0


def phase_tp(torch, card: str, tag: str = "tp"):
    """The rank-process cell ``tag`` of TP_CELLS: phase tp (qwen3-14b,
    then moonshot), tp4 (glm4-9b), ep8's serving (grok-1's smoke config)
    or rec's (xlstm-125m), one rank process a rank, all on the one
    card."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()                   # the earlier models are gone
    size, _, parts = TP_CELLS[tag]
    out_dir = os.path.join(ROOT, "chiprun_out", tag)
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, f))
    t0 = time.perf_counter()
    mesh.run_ranks(lambda r, store: [
        sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
        "--tp-tag", tag, "--rendezvous", store, "--out", out_dir],
        size, timeout=TP_TIMEOUT_S)
    ranks = []
    for r in range(size):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    def ms(calls):
        c = sorted(calls)
        return (f"median {statistics.median(c):.4f}, min {c[0]:.4f}, max "
                f"{c[-1]:.4f} ms a call")

    for res in (r for r in ranks if "ep" in r.get("world", {})):
        ws = res["world"]
        print(f"[{tag}] rank {res['rank']} on {res['device']} "
              f"({res['backend']} groups): through PeerWorld.from_group, "
              f"bit-equal to the plain versions, pads exact, back to back "
              f"between the processes of each world (all {size} ranks "
              f"taking turns on one card): "
              + "; ".join(
                  f"{name} world {w['group']} ({w['row_bytes']} bytes a "
                  f"row): fc_ar x {len(w['probe_ms'])} (n {w['ar_n']}) "
                  f"{ms(w['probe_ms'])}" for name, w in ws.items()
                  if name != "ep")
              + f"; ep world {ws['ep']['group']} ({ws['ep']['row_bytes']} "
              f"bytes a row): " + "; ".join(
                  f"fc_a2a {shape} ({ws['ep']['a2a_rows'][shape]} rows a "
                  f"peer) x {len(v)} {ms(v)}"
                  for shape, v in ws["ep"]["a2a_ms"].items())
              + f"  [{card}]", flush=True)
    for res in (r for r in ranks if "caps" in r.get("world", {})):
        w = res["world"]
        caps = {k: sorted({v for c, v in w["caps"].items()
                           if ("a2a" in c) == (k == "fc_a2a")})
                for k in ("fc_a2a", "fc_ar")}
        a2a = (f" and fc_a2a x {w['a2a_calls']} ({w['a2a_rows']} rows a "
               f"peer)" if "a2a_ms" in w else "")
        print(f"[{tag}] rank {res['rank']} on {res['device']} "
              f"({res['backend']} group, receive rows of {res['row_bytes']} "
              f"bytes): fc_ar x {w['ar_calls']} (decode n {w['ar_n']}){a2a} "
              f"through PeerWorld.from_group bit-equal to the plain "
              f"versions, pads exact (epochs {w['epochs']}, caps {caps}, "
              f"fc_ar {w['ar_blocks']}"
              + (f" and fc_a2a {w['a2a_blocks']}" if a2a else "")
              + f" blocks a call); back to back, between the {size} "
              f"processes: fc_ar x {len(w['probe_ms'])} {ms(w['probe_ms'])}"
              + "".join(f"; fc_a2a {shape} x {len(v)} {ms(v)}"
                        for shape, v in w.get("a2a_ms", {}).items())
              + f" (ranks taking turns on one card)  [{card}]", flush=True)
    for part, _, runs, ptag, _ in parts:
        for label, _, _ in runs:
            r0 = ranks[0][part]["runs"][label]
            check(all(r[part]["runs"][label]["generated"] == r0["generated"]
                      for r in ranks), f"{ptag} {label}: ranks generated "
                  f"different tokens")
            routes = (f"; routes dropped prefill {r0['dropped_prefill']} of "
                      f"{r0['routes_prefill']}, decode {r0['dropped_decode']} "
                      f"of {r0['routes_decode']} (rank 0)"
                      if "dropped_prefill" in r0 else "")
            agree = (f"; prefill/decode logit divergence "
                     f"{max(r0['agreement']['rel_divergence']):.4f}"
                     if r0.get("agreement") else "")
            peaks = ", ".join(f"rank {r['rank']} {r[part]['peak_gb'][label]:.2f}"
                              for r in ranks)
            print(f"[{ptag} {label}] {ranks[0][part]['arch']} "
                  f"({ranks[0][part]['layers']} layers): TTFT "
                  f"{r0['ttft_ms']:.1f} ms, decode median "
                  f"{r0['step_ms_median']:.2f} ms/step, p90 "
                  f"{r0['step_ms_p90']:.2f} (rank 0; {size} ranks taking "
                  f"turns on one card, not NVLink time){routes}{agree}; peak "
                  f"memory {peaks} GB  [{card}]", flush=True)
    print(f"[{tag}] {size} rank processes done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ranks


# ---------------------------------------------------------------------------
# phase train: llama3-8b trained at full width, depth cut
# ---------------------------------------------------------------------------

def _train_cfg(arch: str = TRAIN_ARCH):
    """Phase train's llama3-8b (TRAIN_REPEATS layers) or phase
    moe_train's moonshot (its dense prefix block and TRAIN_MOE_REPEATS
    MoE blocks), at full width; phase ep8's grok-1 smoke config; phase
    kinds_train's archs at full width, their depth KINDS_TRAIN's."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    if arch == EP_ARCH:
        return get_smoke_config(arch)
    kinds = dict(KINDS_TRAIN)
    if arch in kinds:
        return get_config(arch) if kinds[arch] is None else \
            dataclasses.replace(get_config(arch),
                                pattern_repeats=kinds[arch])
    return dataclasses.replace(get_config(arch), pattern_repeats=(
        TRAIN_REPEATS if arch == TRAIN_ARCH else TRAIN_MOE_REPEATS))


def _train_tag(arch: str) -> str:
    if arch in dict(KINDS_TRAIN):
        return "kinds_train"
    return {TRAIN_ARCH: "train", MOE_ARCH: "moe_train",
            EP_ARCH: "ep8_train"}[arch]


def _train_seq(arch: str) -> int:
    """Tokens a row of a training run: TRAIN_SEQ, xlstm's
    KINDS_XLSTM_SEQ."""
    return KINDS_XLSTM_SEQ if arch == XLSTM_ARCH else TRAIN_SEQ


def _sections(lay):
    """A wire layout's sections in wire order."""
    secs = [s for _, s in lay.planes] + [lay.scale, lay.zero]
    return secs + [s for s in (lay.spike_vals, lay.spike_idx) if s]


def _wire_piece(torch, wire, cfg, n: int, c0: int, c1: int):
    """The wire of columns c0..c1 (group and byte aligned) of rows of
    ``n`` values, cut from their wire: each section holds its values'
    bytes in column order."""
    full, part = cfg.wire_layout(n), cfg.wire_layout(c1 - c0)
    return torch.cat([wire[:, f.offset + c0 * f.nbytes // n:
                           f.offset + c0 * f.nbytes // n + p.nbytes]
                      for f, p in zip(_sections(full), _sections(part))],
                     dim=1)


def _train_kernel_checks(torch, card: str) -> dict:
    """fc_encode_wire, fc_decode_wire and fc_decode_reduce at the training
    path's largest leaves against their plain versions, bit for bit: the
    plain versions run in TRAIN_PIECE-column pieces (a group's bytes do
    not depend on other groups), each piece held against the same columns
    of the kernel's result. Then each kernel's time (CUDA events) beside
    its bytes bound."""
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import wire
    cfg = _train_cfg()
    emb = cfg.vocab * cfg.d_model                  # one embedding leaf
    mlp = cfg.d_model * cfg.d_ff                   # one MLP leaf a layer
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    out = {}
    for shape_label, rows, n in (("embedding leaf", 1, emb),
                                 ("embedding leaf / 2", 2, emb // 2),
                                 ("stacked mlp leaf", TRAIN_REPEATS, mlp)):
        x = torch.randn((rows, n), generator=gen, device=dev) * 1e-3
        x[0, 12345] = 0.5                           # an outlier
        for label, kw in TRAIN_LEAF_CONFIGS:
            c = CommConfig(**kw)
            enc = wire.encode_wire(x, c)
            dec = wire.decode_wire(enc, c, n)
            red = wire.decode_reduce(enc, c, n)
            for c0 in range(0, n, TRAIN_PIECE):
                c1 = min(n, c0 + TRAIN_PIECE)
                w = wire.encode_plain(x[:, c0:c1].contiguous(), c)
                check(torch.equal(_wire_piece(torch, enc, c, n, c0, c1), w),
                      f"encode_wire {label} {shape_label} columns "
                      f"{c0}:{c1} differ from plain")
                check(_bits_equal(torch, dec[:, c0:c1],
                                  wire.decode_plain(w, c, c1 - c0)),
                      f"decode_wire {label} {shape_label} columns "
                      f"{c0}:{c1} differ from plain")
                check(_bits_equal(torch, red[:, c0:c1],
                                  wire.decode_reduce_plain(w, c, c1 - c0)),
                      f"decode_reduce {label} {shape_label} columns "
                      f"{c0}:{c1} differ from plain")
            row = {}
            for name, fn in (
                    ("encode_wire", lambda: wire.encode_wire(x, c)),
                    ("decode_wire", lambda: wire.decode_wire(enc, c, n)),
                    ("decode_reduce", lambda: wire.decode_reduce(enc, c, n))):
                ms = _time_ms(torch, fn, runs=5, warmup=2)
                bound = wire.bound_bytes(name, c, rows, n) / \
                    HBM_BYTES_PER_S * 1e3
                row[name] = {"ms": ms, "bound_ms": bound}
            print(f"[train] kernels at the {shape_label} ({rows}, {n}) "
                  f"{label}: encode, decode, decode+reduce bit-equal to "
                  f"the plain versions (in {TRAIN_PIECE}-column pieces); "
                  + ", ".join(f"{k} {v['ms']:.4f} ms (bound "
                              f"{v['bound_ms']:.4f})"
                              for k, v in row.items())
                  + f" per call  [{card}]", flush=True)
            out[f"{shape_label} {label}"] = {"rows": rows, "n": n, **row}
            del enc, dec, red
        del x
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase crc: fc_crc32c at the framed pod bridge's rows
# ---------------------------------------------------------------------------

def _kernel_device_ms(torch, fn, runs: int = 25) -> dict:
    """Each kernel's mean device time over the launches a torch.profiler
    trace of ``runs`` calls recorded -> {name: (ms, records)}; {} when the
    trace has no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count:
            name = re.search(r"(\w+(<[^>]*>)?)\(", ev.key)
            out[name.group(1) if name else ev.key] = (t / ev.count / 1e3,
                                                      ev.count)
    return out


def phase_crc(torch, card: str) -> dict:
    """fc_crc32c at the framed rows of llama3-8b's embedding gradient leaf
    at the pod site of --mesh 1,1,2 --framed-bridge 8 (hier_pp: 4
    microchunks x 2 ranks = 8 rows, each row's CRC over the config's
    header prefix and its payload, read in place from the framed rows),
    at the leaf's halves as 2 rows, and (the synchronous path) at the pod
    site's length in rows at a pitch of 3 + L: bit-equal to its plain
    version, then its time (CUDA events, median of 5) beside the bound
    (bytes read over 3.35 TB/s) and the plain version's time, and each
    launch's device time (torch.profiler, the mean over a trace of 25
    calls) with the records the trace kept. No PyTorch call computes
    CRC32C: no library time. Only crc32c_rows, crc32c_rows_plain,
    bound_bytes and plan of the kernel's module are called, so that an
    older tree's kernel can be timed by this script."""
    from repro_torch.core import codec, frame
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import crc
    cfg = _train_cfg()
    emb = cfg.vocab * cfg.d_model
    bridge = CommConfig(bits=8, group=128, scheme="hier_pp", framed=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    out = {}
    for label, rows in (("pod site", 8), ("leaf / 2", 2),
                        ("pod site, pitch 3 + L", 8)):
        if label.endswith("3 + L"):
            plen = out["pod site"]["length"]
            buf = torch.randint(0, 256, (rows, 3 + plen), generator=gen,
                                dtype=torch.uint8, device=dev)
            payload, init = buf[:, 3:], crc.MASK
        else:
            x = torch.randn((rows, emb // rows), generator=gen,
                            device=dev) * 1e-3
            buf = codec.encode(x, bridge)
            del x
            plen = buf.shape[1] - 16
            payload = buf[:, 16:]
            init = frame._prefix_register(bridge, plen)
        ring = getattr(crc, "ring_path", None)   # an older tree has none
        path = ("no ring" if ring is None else "ring" if ring(
            payload.data_ptr(), payload.stride(0), plen) else "synchronous")
        got = crc.crc32c_rows(payload, init)
        check(torch.equal(got, crc.crc32c_rows_plain(payload, init)),
              f"fc_crc32c != plain at the {label} rows ({rows}, {plen})")
        ms = _time_ms(torch, lambda: crc.crc32c_rows(payload, init), runs=5,
                      warmup=2)
        plain_ms = _time_ms(torch, lambda: crc.crc32c_rows_plain(
            payload, init), runs=3, warmup=1)
        launches = _kernel_device_ms(torch,
                                     lambda: crc.crc32c_rows(payload, init))
        bound = crc.bound_bytes(rows, plen) / HBM_BYTES_PER_S * 1e3
        p = crc.plan(plen)
        print(f"[crc] fc_crc32c {label} ({rows}, {plen}) ({path} path; "
              f"{p.tiles} tiles a row, pad {p.pad}; strided): bit-equal to "
              f"plain; {ms:.4f} ms a call (bound {bound:.4f}, bytes; "
              f"{bound / ms:.2f} of the bound), plain {plain_ms:.4f} ms, "
              f"library none; device "
              + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]} of 25 records)"
                          for k, v in sorted(launches.items()))
              + f"  [{card}]", flush=True)
        out[label] = {"rows": rows, "length": plen, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": "bytes", "max_abs_err": 0.0,
                      "path": path, "launch_ms": launches}
        del buf, payload, got
        torch.cuda.empty_cache()
    return out


def _train_store(torch, cfg, plan, dev, rank: int = 0, data_rank: int = 0):
    """This rank's store from SEED (init_store), its zero-initialised
    output projections filled from a fan-in normal (seeded by SEED + 1 and
    the TP rank, drawn whole and sharded), so that every TP site carries
    data from step 0; the zero vectors as _fill_output_projections fills
    them (a recurrent model's gate vectors and biases sharded over TP
    from a standard normal, a biased model's every bias from a normal of
    std BIAS_STD), a replicated one from a generator of its own, the same
    on every rank."""
    from repro_torch.models.model import param_groups
    from repro_torch.parallel.shardings import init_store
    store = init_store(cfg, plan, SEED, dev, rank, data_rank)
    vectors = bool(set(cfg.layer_kinds) & {"rec", "mlstm", "slstm"})
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1 + 1000003 * rank)
    rgen = torch.Generator(device=dev)
    rgen.manual_seed(SEED + 2000003)
    for g, (_, specs) in sorted(param_groups(cfg, plan).items()):
        for name, sp in sorted(specs.items()):
            if sp.init != "zeros" or not (
                    len(sp.shape) > 1 or cfg.use_bias
                    or (vectors and sp.tp_dim is not None)):
                continue
            replicated = sp.tp_dim is None and sp.moe_fold is None
            t = store[g][name]
            shape = sp.local_shape(plan)
            std = (shape[-2] ** -0.5 if len(shape) > 1
                   else BIAS_STD if cfg.use_bias else 1.0)
            lo = data_rank * t.shape[1]
            for i in range(t.shape[0]):
                v = (torch.randn(shape, generator=rgen if replicated else gen,
                                 device=dev) * std
                     ).reshape(-1)[lo:lo + t.shape[1]]
                t[i, :v.shape[0]] = v
    return store


def _train_counts():
    from repro_torch.kernels import crc, rdma, stage, wire
    return {**wire.LAUNCHES, **stage.LAUNCHES, **rdma.LAUNCHES,
            **crc.LAUNCHES}


def _world_rows(axis):
    """The receive-row bytes of an axis's peer world, or None."""
    return None if axis is None or axis.world is None else \
        axis.world.row_bytes


#: TP sites a block of each kind (a moe block's attention: its experts'
#: outputs cross the ranks in the dispatch; an mlstm or slstm block has no
#: MLP; a dec block's self-attention, cross-attention and MLP), and an
#: encoder's enc block's (at layer=None)
KIND_SITES = {"dense": 2, "moe": 1, "local": 2, "rec": 2, "mlstm": 1,
              "slstm": 1, "enc": 2, "dec": 3, "xattn": 2}


def _train_expected(cfg, plan, policy, mesh, seq: int = TRAIN_SEQ) -> dict:
    """The launches of each kernel in one train step of ``policy`` on
    ``mesh`` at ``seq`` tokens a row: every TP site of the forward
    (KIND_SITES a block; the encoder's at layer=None, each at its own
    b_loc x n_ctx x d_model), the checkpointed blocks' sites again as the
    backward replays them (the embedding's is not replayed), the tp_bwd
    sites, the qag gathers (forward, and the replay of every block group
    and of the encoder's blocks), the qgrad_rs reduce-scatters, the pod
    grad site of every leaf. A two_step site: 2 encodes and 2 decodes; ``fused``
    over one rank: 2 encodes, a decode+reduce and a decode; ``fused``
    through an axis's peer world: fc_ar once a piece of its rows. A framed
    site (the bridge): fc_crc32c once an encode and once a decode. An MoE
    block has one TP site and a dispatch, forward and replayed: quantized
    over the process group, an encode and a decode; ``fused`` through the
    peer world (the ep world with ep and etp both above 1), fc_a2a; its
    backward is exact. With etp > 1 the block's within-expert AllReduce
    of its ``e_loc * ep * capacity * d_model`` partial sums is a site too,
    forward and replayed, through the etp world; its backward is
    exact."""
    from repro_torch.core.collectives import group_size
    from repro_torch.models.model import param_groups
    from repro_torch.models.moe import capacity
    from repro_torch.train.train_step import (_qgrad_active, pod_grad_config,
                                              qgrad_rs_config, wants_grad_ef)
    want = dict.fromkeys(_train_counts(), 0)
    pol = policy.bind(cfg.n_layers)

    def pieces(n: int, tp: int, c, rows) -> int:
        if rows is None or c.wire_bytes(n // tp) <= rows:
            return 1
        piece = tp * c.group * (rows // c.wire_bytes(c.group))
        return -(-n // piece)

    def psum(c, n: int, tp: int, peer_rows, times: int = 1):
        if c is None or not c.enabled or c.scheme == "nccl":
            return
        if c.scheme == "fused" and peer_rows is not None:
            mult = tp * c.group
            want["ar"] += times * pieces(-(-n // mult) * mult, tp, c,
                                         peer_rows)
        elif c.scheme == "fused":
            want["encode_wire"] += 2 * times
            want["decode_reduce"] += times
            want["decode_wire"] += times
        else:
            want["encode_wire"] += 2 * times
            want["decode_wire"] += 2 * times
            if c.framed:
                want["crc32c"] += 4 * times

    b_loc = TRAIN_BATCH // (group_size(mesh.data) * (
        group_size(mesh.pod) if mesh.multi_pod else 1))
    act = b_loc * seq * cfg.d_model
    tp, rows = plan.tp, _world_rows(mesh.model)
    sub = mesh.model is not None and mesh.model.ep is not None
    a2a_rows = _world_rows(mesh.model.ep) if sub else rows
    kinds = cfg.layer_kinds
    # (layer, values, times in the forward and its replay) of each site
    sites = [(None, act, 1)]                   # the embedding's
    if cfg.is_enc_dec:
        sites += [(None, b_loc * cfg.encoder.n_ctx * cfg.d_model, 2)] * (
            KIND_SITES["enc"] * cfg.encoder.n_layers)
    sites += [(layer, act, 2) for layer in range(cfg.n_layers)
              for _ in range(KIND_SITES[kinds[layer]])]
    for layer, n, times in sites:
        psum(pol.resolve("tp", layer), n, tp, rows, times=times)
        psum(pol.resolve("tp_bwd", layer), n, tp, rows)
    for layer in range(cfg.n_layers):
        c = pol.resolve("a2a", layer)
        if kinds[layer] != "moe" or c is None or not c.enabled or \
                c.scheme == "nccl":
            continue
        if c.scheme == "fused" and a2a_rows is not None:
            want["a2a"] += 2
        else:
            want["encode_wire"] += 2
            want["decode_wire"] += 2
        mp = plan.moe
        if mp.etp > 1:
            t = b_loc * seq
            cap = capacity(-(-t // mp.ep) if pol.ep_slice and mp.ep > 1
                           else t, cfg)
            psum(pol.resolve("tp", layer), mp.e_loc * mp.ep * cap
                 * cfg.d_model, mp.etp,
                 _world_rows(mesh.model.etp) if sub else rows, times=2)
    groups = param_groups(cfg, plan)
    qag = pol.resolve("qag")
    if plan.fsdp > 1 and qag is not None and qag.enabled:
        for g, (n_stack, specs) in groups.items():
            # a block group's gather is replayed with its blocks
            k = len(specs) * n_stack * (
                1 if g in ("embed", "out", "encoder_extra") else 2)
            want["encode_wire"] += k
            want["decode_wire"] += k
    leaves = [(g, sp) for g, (n_stack, specs) in groups.items()
              for sp in specs.values()]
    if _qgrad_active(pol, plan):
        want["encode_wire"] += len(leaves)
        want["decode_wire"] += len(leaves) * (2 if pol.grad_ef else 1)
    if mesh.multi_pod:
        c, pod = pod_grad_config(pol), group_size(mesh.pod)
        for g, sp in leaves:
            n = groups[g][0] * sp.flat_len(plan) // plan.fsdp
            if wants_grad_ef(pol, mesh) and c.scheme != "fused":
                want["encode_wire"] += 2
                want["decode_wire"] += 4
                if c.framed:
                    want["crc32c"] += 6
                continue
            psum(c, n, pod, _world_rows(mesh.pod))
            if wants_grad_ef(pol, mesh):      # fused: the local QDQ error
                want["encode_wire"] += 1
                want["decode_wire"] += 1
    return want


def _train_one(torch, cfg, plan, mesh, dev, label: str, policy,
               steps: int, tag: str, log, card: str, expected=None,
               snapshot: bool = False, seq: int = TRAIN_SEQ) -> dict:
    """Train ``steps`` steps of ``policy`` from the filled SEED store,
    TRAIN_BATCH x ``seq`` tokens a step;
    per-step launch counts (each must equal ``expected``), ms/step
    (median and p90 of steps 1-3, host clock, synchronised), tokens/s,
    peak memory, an MoE model's routes dropped over capacity; with
    ``snapshot``, the metrics of the first TRAIN_CHECK_STEPS steps and
    the store after them, on the host."""
    from repro_torch.launch.train import train
    from repro_torch.parallel.axis import axis_rank
    from repro_torch.train.optim import OptimConfig
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=max(steps // 20, 2),
                          total_steps=steps)
    store = _train_store(torch, cfg, plan, dev, axis_rank(mesh.model),
                         axis_rank(mesh.data))
    counts, snap, metrics, stats = [], {}, [], {}
    last = [_train_counts()]

    t0 = time.perf_counter()

    def on_step(i, st, opt, m):
        now = _train_counts()
        counts.append({k: now[k] - last[0][k] for k in now})
        last[0] = now
        metrics.append({k: float(v) for k, v in m.items()})
        log(f"[{tag} {label}] step {i}: loss {metrics[-1]['loss']:.6f}, "
            f"{time.perf_counter() - t0:.1f} s since the start, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak",
            flush=True)
        if snapshot and i == TRAIN_CHECK_STEPS - 1:
            snap["store"] = {g: {n: t.to("cpu", copy=True)
                                 for n, t in gg.items()}
                             for g, gg in st.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, plan, policy, opt_cfg, mesh, batch=TRAIN_BATCH,
                seq=seq, steps=steps, device=dev, seed=SEED,
                log_every=steps, log=lambda *a, **k: None, store=store,
                on_step=on_step, stats=stats)
    routes = (int(stats["routes"]), int(stats["dropped"])) if stats else None
    peak = torch.cuda.max_memory_allocated() / 1e9
    ef = res["opt"].get("ef")
    ef_abs = (max(float(t.abs().max()) for gg in ef.values()
                  for t in gg.values()) if ef is not None else None)
    step_ms = res["step_ms"]
    del res, store, ef
    torch.cuda.empty_cache()
    for c in counts:
        check(expected is None or c == expected,
              f"{tag} {label}: launches a step {c} != {expected}")
    timed = step_ms[1:] or step_ms
    med = statistics.median(timed)
    p90 = float(sorted(timed)[max(0, -(-9 * len(timed) // 10) - 1)])
    tps = TRAIN_BATCH * seq * 1e3 / med
    losses = [m["loss"] for m in metrics]
    check(all(math.isfinite(v) for v in losses),
          f"{tag} {label}: loss not finite: {losses}")
    log(f"[{tag} {label}] {cfg.name} ({cfg.n_layers} layers, full width), "
        f"global batch {TRAIN_BATCH} x seq {seq}: loss "
        f"{[round(v, 6) for v in losses]}, grad norm "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; {len(timed)} "
        f"steps after the first: median {med:.1f} ms/step, p90 {p90:.1f} "
        f"(host clock, synchronised), {tps:.0f} tokens/s; peak memory "
        f"{peak:.2f} GB; launches a step "
        f"{ {k: v for k, v in counts[0].items() if v} } (expected "
        f"{ {k: v for k, v in (expected or {}).items() if v} })"
        + (f"; EF residual max |ef| {ef_abs:.3e}" if ef_abs is not None
           else "")
        + (f"; routes dropped over capacity {routes[1]} of {routes[0]} "
           f"over {steps} steps (this rank's forwards)" if routes else "")
        + (f"  [{card}]" if card else ""), flush=True)
    return {"label": label, "metrics": metrics, "counts": counts,
            "expected": expected, "step_ms": step_ms, "median_ms": med,
            "p90_ms": p90, "tokens_per_s": tps, "peak_gb": peak,
            "ef_max_abs": ef_abs, "routes": routes}, snap


def _snap_equal(torch, a: dict, b: dict) -> bool:
    """Whether two snapshots' metrics and stores are bit-equal."""
    return all(_bits_equal(torch, a["store"][g][n], b["store"][g][n])
               for g in a["store"] for n in a["store"][g])


def _train_single(torch, card: str, dev=None, arch: str = TRAIN_ARCH
                  ) -> dict:
    """--mesh 1,1 in this process: bf16 (llama3-8b and phase
    kinds_train's archs), then paper through the CUDA codec, then paper
    through the plain codec (TRAIN_CHECK_STEPS steps): loss, grad norm
    and the store after TRAIN_CHECK_STEPS steps bit-equal; paper's step-0
    loss within TRAIN_LOSS_REL (llama3-8b) or KINDS_LOSS_REL (phase
    kinds_train) of bf16's."""
    from repro_torch.launch.train import build_policy
    from repro_torch.parallel.axis import MeshAxes
    from repro_torch.parallel.plan import make_plan
    cfg, mesh, seq = _train_cfg(arch), MeshAxes(), _train_seq(arch)
    dense, kinds = arch == TRAIN_ARCH, arch in dict(KINDS_TRAIN)
    tag = f"{_train_tag(arch)} 1,1" + (f" {arch}" if kinds else "")
    steps = TRAIN_CHECK_STEPS if kinds else TRAIN_STEPS
    dev = dev or torch.device("cuda")
    plan = make_plan(cfg, tp=1, fsdp=1)
    runs = {}
    for label, pol, backend, n in (
            (("bf16", "bf16", "auto", steps),) if dense or kinds else ()) + (
            ("paper", "paper", "auto", steps),
            ("paper/plain codec", "paper", "ref", TRAIN_CHECK_STEPS)):
        policy = build_policy(pol, backend=backend)
        expected = _train_expected(cfg, plan, policy, mesh, seq) \
            if backend != "ref" else dict.fromkeys(_train_counts(), 0)
        runs[label] = _train_one(torch, cfg, plan, mesh, dev, label, policy,
                                 n, tag, print, card, expected,
                                 snapshot=pol == "paper", seq=seq)
    (cuda, snap_c), (plain, snap_p) = runs["paper"], runs["paper/plain codec"]
    k = TRAIN_CHECK_STEPS
    check(cuda["metrics"][:k] == plain["metrics"][:k] and
          _snap_equal(torch, snap_c, snap_p),
          f"{tag}: paper through the CUDA codec differs from the plain "
          f"codec over {k} steps: {cuda['metrics'][:k]} vs "
          f"{plain['metrics'][:k]}")
    del snap_c, snap_p
    same = (f"[{tag}] paper through the CUDA codec equals the plain codec "
            f"over {k} steps (loss, grad norm, every parameter, bit for "
            f"bit)")
    if not (dense or kinds):
        print(same, flush=True)
        return {label: r for label, (r, _) in runs.items()}
    bound = TRAIN_LOSS_REL if dense else KINDS_LOSS_REL[arch]
    l0, b0 = cuda["metrics"][0]["loss"], runs["bf16"][0]["metrics"][0]["loss"]
    print(f"{same}; its step-0 loss {l0:.6f} against bf16's {b0:.6f}: "
          f"{abs(l0 - b0) / abs(b0):.3e} relative (bound {bound})",
          flush=True)
    check(abs(l0 - b0) <= bound * abs(b0),
          f"{tag}: paper's step-0 loss {l0} is not within {bound} of "
          f"bf16's {b0}")
    return {label: r for label, (r, _) in runs.items()}


def _train_meshes(arch: str):
    return dict({TRAIN_ARCH: TRAIN_MESHES, MOE_ARCH: TRAIN_MOE_MESHES,
                 EP_ARCH: EP_TRAIN_MESHES,
                 WHISPER_ARCH: KINDS_TRAIN_MESHES}.get(arch, ()))


def train_rank_main(rank: int, mesh_spec: str, rendezvous: str,
                    out_dir: str, arch: str = TRAIN_ARCH) -> int:
    """One rank process of phase train or moe_train (``chip_smoke.py
    --train-rank``): the runs of the mesh ``mesh_spec`` (TRAIN_MESHES, or
    TRAIN_MOE_MESHES for moonshot); with both, paper/fused equal to
    paper/two_step over TRAIN_CHECK_STEPS steps, and depth's EF residual
    non-zero."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import build_policy
    from repro_torch.parallel.plan import make_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    data, model, pod = mesh_lib.parse_train_mesh(mesh_spec)
    dev = mesh_lib.rank_device(rank, torch.device("cuda"))
    cfg, seq = _train_cfg(arch), _train_seq(arch)
    plan = make_plan(cfg, tp=model, fsdp=data)
    b_loc = TRAIN_BATCH // (data * max(pod, 1))
    mesh = mesh_lib.init_mesh(data, model, pod, rank, rendezvous, dev,
                              mesh_lib.site_row_bytes(cfg, plan, b_loc,
                                                      seq), plan.moe)
    log = print if rank == 0 else (lambda *a, **k: None)
    tag = f"{_train_tag(arch)} {mesh_spec}"
    sites = ("the TP sites through fc_ar, the dispatch through fc_a2a"
             if cfg.moe is not None else
             "every TP site through fc_ar, the encoder's included"
             if model > 1 else "the grad site through fc_ar")
    if cfg.moe is not None and plan.moe.etp > 1:
        sites += (" over the ep world, the within-expert AllReduce through "
                  "fc_ar over the etp world")
    try:
        runs, snaps = {}, {}
        for label, pol, scheme, bridge, steps in \
                _train_meshes(arch)[mesh_spec]:
            policy = build_policy(pol, scheme=scheme, framed_bridge=bridge)
            expected = _train_expected(cfg, plan, policy, mesh, seq)
            runs[label], snap = _train_one(
                torch, cfg, plan, mesh, dev, label, policy, steps, tag,
                log, "", expected, snapshot=label.startswith("paper/"),
                seq=seq)
            if snap:
                snaps[label] = snap
        if "paper/fused" in runs:
            k = TRAIN_CHECK_STEPS
            a, b = runs["paper/fused"], runs["paper/two_step"]
            check(a["metrics"][:k] == b["metrics"][:k] and _snap_equal(
                torch, snaps["paper/fused"], snaps["paper/two_step"]),
                f"{tag} rank {rank}: paper/fused differs from "
                f"paper/two_step over {k} steps")
            log(f"[{tag}] every rank: paper/fused ({sites}) equals "
                f"paper/two_step over {k} steps (loss, grad norm, every "
                f"parameter, bit for bit)", flush=True)
        if FRAMED_LABEL in runs:
            k = TRAIN_CHECK_STEPS
            a, b = runs[FRAMED_LABEL], runs["paper/two_step"]
            snap = snaps[FRAMED_LABEL]["store"]
            check(all(bool(torch.isfinite(t).all()) for gg in snap.values()
                      for t in gg.values()) and all(
                math.isfinite(m["grad_norm"]) for m in a["metrics"]),
                f"{tag} rank {rank}: a NaN in the framed-bridge run")
            check(a["metrics"][:k] == b["metrics"][:k] and _snap_equal(
                torch, snaps[FRAMED_LABEL], snaps["paper/two_step"]),
                f"{tag} rank {rank}: {FRAMED_LABEL} differs from "
                f"paper/two_step over {k} steps: {a['metrics'][:k]} vs "
                f"{b['metrics'][:k]}")
            log(f"[{tag}] every rank: {FRAMED_LABEL} (the pod hop int8 g128 "
                f"hier_pp in frames, fc_crc32c "
                f"{a['counts'][0].get('crc32c', 0)} launches a step) equals "
                f"paper/two_step over {k} steps (loss, grad norm, every "
                f"parameter, bit for bit), no NaN", flush=True)
        if "depth" in runs:
            ef = runs["depth"]["ef_max_abs"]
            check(ef is not None and ef > 0,
                  f"{tag} rank {rank}: depth's EF residual is {ef}")
        res = {"rank": rank, "device": str(dev), "runs": runs}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        mesh_lib.close_mesh(mesh)
    return 0


def _train_ranks(torch, card: str, mesh_spec: str,
                 arch: str = TRAIN_ARCH) -> list:
    """The runs of mesh ``mesh_spec`` (TRAIN_MESHES, TRAIN_MOE_MESHES for
    moonshot, EP_TRAIN_MESHES for grok-1's smoke config) in one rank
    process a rank (all on the one card, taking turns on it)."""
    from repro_torch.launch import mesh as mesh_lib
    data, model, pod = mesh_lib.parse_train_mesh(mesh_spec)
    world = max(pod, 1) * data * model
    out_dir = os.path.join(ROOT, "chiprun_out", "train")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, f))
    t0 = time.perf_counter()
    mesh_lib.run_ranks(lambda r, store: [
        sys.executable, os.path.abspath(__file__), "--train-rank", str(r),
        "--train-mesh", mesh_spec, "--train-arch", arch, "--rendezvous",
        store, "--out", out_dir], world, timeout=TRAIN_TIMEOUT_S)
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    tag = f"{_train_tag(arch)} {mesh_spec}"
    for label, *_ in _train_meshes(arch)[mesh_spec]:
        losses = {json.dumps(r["runs"][label]["metrics"]) for r in ranks}
        check(len(losses) == 1, f"{tag} {label}: the ranks "
              f"report different metrics")
        check(all(math.isfinite(m["loss"]) for m in
                  ranks[0]["runs"][label]["metrics"]),
              f"{tag} {label}: a loss not finite")
        r0 = ranks[0]["runs"][label]
        peaks = ", ".join(f"rank {r['rank']} {r['runs'][label]['peak_gb']:.2f}"
                          for r in ranks)
        print(f"[{tag} {label}] {world} rank processes on one "
              f"card: median {r0['median_ms']:.1f} ms/step, p90 "
              f"{r0['p90_ms']:.1f} (rank 0, host clock; the ranks take turns "
              f"on the card), {r0['tokens_per_s']:.0f} tokens/s; peak memory "
              f"{peaks} GB; launches a step (rank 0) "
              f"{ {k: v for k, v in r0['counts'][0].items() if v} }"
              + (f"; routes dropped {r0['routes'][1]} of {r0['routes'][0]} "
                 f"(rank 0, {len(r0['counts'])} steps)" if r0.get("routes")
                 else "") + f"  [{card}]", flush=True)
    print(f"[{tag}] {world} rank processes done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ranks


def _train_launches(trained: dict, meshes=TRAIN_MESHES) -> dict:
    """Each kernel's launches over phase train's (or moe_train's) runs
    through the kernels (the --mesh 1,1 runs, and rank 0's of the
    others), every step's."""
    total: dict = {}
    runs = list(trained.get("1,1", {}).values())
    for spec, _ in meshes:
        if trained.get(spec):
            runs += list(trained[spec][0]["runs"].values())
    for r in runs:
        for c in r["counts"]:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


def phase_train(torch, card: str) -> dict:
    torch.cuda.empty_cache()                   # the earlier models are gone
    t0 = time.perf_counter()
    print(f"[train] {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
          f"allocated by the earlier phases", flush=True)
    res = {"kernels": _train_kernel_checks(torch, card),
           "1,1": _train_single(torch, card)}
    torch.cuda.empty_cache()
    # the rank processes share the card: expandable segments keep each
    # one's free blocks from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for spec, _ in TRAIN_MESHES:
        res[spec] = _train_ranks(torch, card, spec)
    print(f"[train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def phase_kinds_train(torch, card: str) -> dict:
    """The recurrent, sliding-window, encoder and cross-attention kinds
    trained at full width (KINDS_TRAIN), each arch: --mesh 1,1 in this
    process (bf16, paper through the CUDA codec == the plain codec,
    paper's step-0 loss within KINDS_LOSS_REL of bf16's), then its
    KINDS_TRAIN_MESHES as rank processes (whisper-tiny at --mesh 1,2:
    paper/fused, every TP site through fc_ar, == paper/two_step) ->
    {arch: {mesh: runs}}."""
    from repro_torch.launch.train import param_count
    t0 = time.perf_counter()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    res = {}
    for arch, _ in KINDS_TRAIN:
        torch.cuda.empty_cache()               # the earlier models are gone
        cfg = _train_cfg(arch)
        print(f"[kinds_train] {arch} at full width, {cfg.n_layers} "
              f"blocks ({', '.join(cfg.layer_kinds)})"
              + (f" and {cfg.encoder.n_layers} enc blocks over "
                 f"{cfg.encoder.n_ctx} frames" if cfg.is_enc_dec else "")
              + f": {param_count(cfg) / 1e9:.3f} B parameters, global batch "
              f"{TRAIN_BATCH} x seq {_train_seq(arch)}", flush=True)
        res[arch] = {"1,1": _train_single(torch, card, arch=arch)}
        torch.cuda.empty_cache()
        for spec, _ in KINDS_TRAIN_MESHES if arch == WHISPER_ARCH else ():
            res[arch][spec] = _train_ranks(torch, card, spec, arch=arch)
    print(f"[kinds_train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def _kinds_train_launches(trained: dict) -> dict:
    """Each kernel's launches over phase kinds_train's runs (rank 0's of
    the rank-process runs), every step's."""
    total: dict = {}
    for arch, runs in trained.items():
        for k, v in _train_launches(runs, KINDS_TRAIN_MESHES).items():
            total[k] = total.get(k, 0) + v
    return total


def phase_moe_train(torch, card: str) -> dict:
    """moonshot-v1-16b-a3b trained at full width (_train_cfg): --mesh 1,1
    in this process (the CUDA codec == the plain codec), then
    TRAIN_MOE_MESHES as rank processes (ep = 2: paper/fused, the dispatch
    through fc_a2a, == paper/two_step)."""
    from repro_torch.launch.train import param_count
    torch.cuda.empty_cache()                   # the earlier models are gone
    t0 = time.perf_counter()
    cfg = _train_cfg(MOE_ARCH)
    print(f"[moe_train] {MOE_ARCH} at full width, {cfg.n_layers} of its 48 "
          f"layers ({', '.join(cfg.layer_kinds)}): "
          f"{param_count(cfg) / 1e9:.3f} B parameters", flush=True)
    res = {"1,1": _train_single(torch, card, arch=MOE_ARCH)}
    torch.cuda.empty_cache()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for spec, _ in TRAIN_MOE_MESHES:
        res[spec] = _train_ranks(torch, card, spec, arch=MOE_ARCH)
    print(f"[moe_train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def _rec_window(torch, card: str) -> dict:
    """recurrentgemma-2b's (rec, rec, local) repeat alone at full width
    (no suffix), served REC_WINDOW_PROMPT tokens, past its window, and
    REC_WINDOW_GEN more under bf16: the local block's ring holds exactly
    ``window`` slots, and after the run every slot holds one of the last
    ``window`` positions; prefill and decode agree to CACHE_REL_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import wire
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(REC_ARCH), pattern_repeats=1,
                              suffix=())
    plan = make_plan(cfg, tp=1)
    params = init_params(cfg, plan, SEED, dev, torch.bfloat16)
    _fill_output_projections(torch, cfg, plan, params, SEED + 1)
    wire.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = serve(params, cfg, plan, build_policy("bf16"), batch=BATCH,
                prompt_len=REC_WINDOW_PROMPT, gen=REC_WINDOW_GEN,
                device=dev, seed=SEED, label=" rec window bf16",
                keep_caches=True)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(set(wire.LAUNCHES.values()) == {0},
          f"rec window: wire kernels launched under bf16: {wire.LAUNCHES}")
    ring = res.pop("caches")["layers"][cfg.layer_kinds.index("local")]
    last = REC_WINDOW_PROMPT + REC_WINDOW_GEN - 2    # the last decoded
    spos = ring["slot_pos"]
    check(tuple(spos.shape) == (cfg.window,)
          and ring["k"].shape[1] == cfg.window,
          f"rec window: a ring of {tuple(spos.shape)} slots, not "
          f"{cfg.window}")
    check(bool((spos > last - cfg.window).all()), f"rec window: a slot "
          f"outside the window: min {int(spos.min())} <= "
          f"{last - cfg.window}")
    rel = max(res["agreement"]["rel_divergence"])
    check(rel <= CACHE_REL_TOL, f"rec window: prefill/decode logit "
          f"divergence {rel} > {CACHE_REL_TOL}")
    print(f"[rec window bf16] {cfg.name} ({', '.join(cfg.layer_kinds)}), "
          f"window {cfg.window}: prompt {REC_WINDOW_PROMPT} + "
          f"{REC_WINDOW_GEN} tokens x{BATCH}: TTFT {res['ttft_ms']:.1f} ms, "
          f"decode median {res['step_ms_median']:.2f} ms/step, p90 "
          f"{res['step_ms_p90']:.2f}; the ring's {cfg.window} slots hold "
          f"positions {int(spos.min())}..{int(spos.max())}; prefill/decode "
          f"logit divergence {rel:.4f}; peak memory {res['peak_gb']:.2f} GB"
          f"  [{card}]", flush=True)
    del params, ring, spos
    return res


def _census(torch, cfg, plan, params, prompts, embeds, tag: str,
            card: str) -> dict:
    """The device operations (kernels and copies) that one prefill of
    ``prompts`` and one decode step of ``cfg`` at tp = 1 launch under
    paper/two_step (CUDA codec) on the served ``params`` (given
    ``embeds``, a model with an encoder or cross-attention), counted in a
    torch.profiler trace of one call, with their summed device time,
    beside the call's time on the host's clock (synchronised, median of
    3, outside the trace); for an encoder-decoder model also one pass of
    its encoder alone, which every decode step runs again -> {"prefill" |
    "decode" | "encoder": {...}}; the device's idle share in a call is
    1 - device / wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import build_policy
    from repro_torch.models.model import _encode
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step, make_prefill)
    dev = prompts.device
    policy = build_policy("paper")
    prefill = make_prefill(cfg, plan, policy)
    step = make_decode_step(cfg, plan, policy)
    caches = make_cache_init(cfg, plan, BATCH, 8, dev)()
    calls = {"prefill": (lambda: prefill(params, prompts, embeds),
                         f"{BATCH} x {PROMPT_LEN} tokens"),
             "decode": (lambda: step(params, caches, prompts[:, :1],
                                     embeds), f"{BATCH} x 1 tokens")}
    if cfg.is_enc_dec:
        def encode():
            return _encode(lambda g, i: {k: v[i] for k, v in
                                         params[g].items()},
                           embeds.to(torch.bfloat16), cfg, plan,
                           policy.bind(cfg.n_layers), group=None, rank=0)
        calls["encoder"] = (encode, f"{BATCH} x {cfg.encoder.n_ctx} frames, "
                            f"{cfg.encoder.n_layers} enc blocks")
    out = {}
    for name, (fn, what) in calls.items():
        walls = []
        for _ in range(4):                 # a warm-up call, then 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [(ev.count, getattr(ev, "self_device_time_total",
                                  getattr(ev, "self_cuda_time_total", 0.0)))
               for ev in prof.key_averages()]
        evs = [(n, us) for n, us in evs if us > 0]
        dev_ms = sum(us for _, us in evs) / 1e3
        wall = statistics.median(walls[1:])
        out[name] = {"kernels": sum(n for n, _ in evs),
                     "device_ms": dev_ms, "wall_ms": wall}
        print(f"[{tag} census] {cfg.name} paper/two_step {name} ({what}): "
              f"{out[name]['kernels']} device operations (kernels and "
              f"copies) in a profiler trace of one call, {dev_ms:.2f} ms "
              f"on the device, {wall:.2f} ms on the host's clock (idle "
              f"share {1 - dev_ms / wall if wall else float('nan'):.3f})"
              f"  [{card}]", flush=True)
    if cfg.is_enc_dec:
        out["encoder_share"] = {k: out["encoder"][k] / out["decode"][k]
                                for k in ("kernels", "device_ms",
                                          "wall_ms")}
        print(f"[{tag} census] {cfg.name}: the encoder re-run in a decode "
              f"step is {out['encoder_share']['kernels']:.3f} of its "
              f"device operations, {out['encoder_share']['device_ms']:.3f} "
              f"of its device time and {out['encoder_share']['wall_ms']:.3f} "
              f"of its host time  [{card}]", flush=True)
    del caches
    return out


def phase_rec(torch, np, card: str):
    """recurrentgemma-2b and xlstm-125m (phase rec): at full width and
    full depth, tp = 1 (_serve_tp1 under REC_RUNS, then, on the same
    weights, the kernels a prefill and a decode step launch: _census),
    recurrentgemma's window run (_rec_window), then xlstm-125m at --mesh
    1,TP (phase_tp's rank processes, XLSTM_TP_REPEATS repeats) -> (the
    launches of the tp = 1 served runs and of rank 0's, {label:
    results})."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    launches, out = {}, {}

    def one(arch):
        torch.cuda.empty_cache()               # the earlier models are gone
        got, out[arch] = _serve_tp1(torch, np, get_config(arch), REC_RUNS,
                                    "rec", card, census=True)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    one(REC_ARCH)
    out["window"] = {"bf16": _rec_window(torch, card)}
    one(XLSTM_ARCH)
    ranks = phase_tp(torch, card, "rec_tp")
    for k, v in ranks[0]["xlstm"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["tp"] = ranks
    print(f"[rec] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, out


def phase_xattn(torch, np, card: str):
    """whisper-tiny (full width and depth) and llama-3.2-vision-11b (full
    width, VISION_REPEATS repeats) at tp = 1 (_serve_tp1 under XATTN_RUNS,
    then _census on the same weights), then whisper-tiny at --mesh 1,TP
    (phase_tp's rank processes, full depth) -> (the launches of the tp = 1
    served runs and of rank 0's, {label: results})."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    launches, out = {}, {}
    for arch, cfg in ((WHISPER_ARCH, get_config(WHISPER_ARCH)),
                      (VISION_ARCH, dataclasses.replace(
                          get_config(VISION_ARCH),
                          pattern_repeats=VISION_REPEATS))):
        torch.cuda.empty_cache()               # the earlier models are gone
        got, out[arch] = _serve_tp1(torch, np, cfg, XATTN_RUNS, "xattn",
                                    card, census=True)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    ranks = phase_tp(torch, card, "xattn_tp")
    for k, v in ranks[0]["whisper"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["tp"] = ranks
    print(f"[xattn] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, out


def phase_ep8(torch, card: str):
    """grok-1's smoke config at --mesh 1,EP_TP (ep 4 x etp 2): served
    (phase_tp's rank processes, EP_TP of them), then trained
    EP_TRAIN_MESHES -> (the serving ranks' results, {mesh: training
    ranks' results})."""
    t0 = time.perf_counter()
    ranks = phase_tp(torch, card, "ep8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    trained = {spec: _train_ranks(torch, card, spec, arch=EP_ARCH)
               for spec, _ in EP_TRAIN_MESHES}
    print(f"[ep8] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ranks, trained


# ---------------------------------------------------------------------------
# phase dp: data-parallel serving (--mesh D,M, D > 1)
# ---------------------------------------------------------------------------

def _dp_cfg():
    """Phase dp's qwen3-14b: full width, DP_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), pattern_repeats=DP_LAYERS)


def _dp_store(torch, cfg, plan, dev, model_rank: int, data_rank: int):
    """The float32 flat store of (model ``model_rank``, data
    ``data_rank``) on ``plan``: init_store's weights from SEED, the
    zero-initialised 2-D output projections filled from a fan-in normal
    (a generator a (group, name, stack, model rank): the same values at
    any fsdp), so that every TP site carries data."""
    import zlib
    from repro_torch.models.model import param_groups
    from repro_torch.parallel.shardings import init_store
    store = init_store(cfg, plan, SEED, dev, model_rank, data_rank)
    for g, (n_stack, specs) in sorted(param_groups(cfg, plan).items()):
        for name, sp in sorted(specs.items()):
            if sp.init != "zeros" or len(sp.shape) < 2:
                continue
            shape = sp.local_shape(plan)
            t = store[g][name]
            lo = data_rank * t.shape[1]
            for i in range(n_stack):
                gen = torch.Generator(device=dev)
                gen.manual_seed(zlib.crc32(
                    f"{SEED}/{g}/{name}/{i}/{model_rank}".encode()))
                v = torch.randn(shape, generator=gen, device=dev).mul_(
                    shape[-2] ** -0.5).reshape(-1)[lo:lo + t.shape[1]]
                t[i, :v.numel()] = v
                del v
    return store


def _qag_gathers(cfg, plan) -> int:
    """Parameters a forward gathers over the data axis: each one group's
    at each stack index, one qag encode and one decode each."""
    from repro_torch.models.model import param_groups
    return sum(n * len(specs) for n, specs in
               param_groups(cfg, plan).values())


def dp_rank_main(rank: int, mesh_spec: str, rendezvous: str,
                 out_dir: str) -> int:
    """One rank process (``chip_smoke.py --dp-rank``) of phase dp's mesh
    ``mesh_spec``: its shard of the flat store, the mesh's checks, then
    its served runs with exact launch counts."""
    import torch
    from repro_torch.kernels import rdma, stage, wire
    from repro_torch.launch import mesh
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.parallel.plan import make_plan
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.serve_step import (local_rows, make_cache_init,
                                              make_decode_step, make_prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    checks, runs = DP_CELLS[mesh_spec]
    data, model = mesh.parse_mesh(mesh_spec)
    cfg = _dp_cfg()
    plan = make_plan(cfg, tp=model, fsdp=data)
    _, d, m = mesh.mesh_coord(rank, data, model)
    dev = mesh.rank_device(rank, torch.device("cuda"))
    b_loc = BATCH // data if BATCH % data == 0 else BATCH
    axes = mesh.init_mesh(data, model, 0, rank, rendezvous, dev,
                          mesh.site_row_bytes(cfg, plan, b_loc, DP_PROMPT))
    rows = local_rows(BATCH, axes.data)
    log = print if rank == 0 else (lambda *a, **k: None)
    kw = dict(group=axes.model, data_group=axes.data)
    try:
        t0 = time.perf_counter()
        store = _dp_store(torch, cfg, plan, dev, m, d)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * 4 for g in store.values()
                     for t in g.values())
        log(f"[dp {mesh_spec}] {cfg.name} full width, {cfg.n_layers} "
            f"layers at --mesh {mesh_spec}: {nbytes / 1e9:.2f} GB float32 "
            f"store a rank ({nbytes * data * model / 1e9:.2f} GB in all) "
            f"from seed {SEED} in {time.perf_counter() - t0:.1f} s; "
            f"{b_loc} of {BATCH} rows a replica", flush=True)
        prompts = torch.from_numpy(make_dataset(DataConfig(
            vocab=cfg.vocab, seq_len=DP_PROMPT, global_batch=BATCH,
            seed=SEED)).batch(0)["tokens"][rows]).to(dev)
        res = {"rank": rank, "coord": [d, m], "rows": [rows.start, rows.stop]}

        def logits_of(policy):
            """This replica's prefill logits, then DP_CHECK_STEPS
            decode steps' logits (f32 (b_loc, v_loc) each), on rings of
            the served runs' length."""
            out = [make_prefill(cfg, plan, policy, **kw)(store, prompts)]
            step = make_decode_step(cfg, plan, policy, **kw)
            caches = make_cache_init(cfg, plan, b_loc, DP_PROMPT + DP_GEN,
                                     dev)()
            for i in range(DP_CHECK_STEPS):
                lg, caches = step(store, caches, prompts[:, i:i + 1])
                out.append(lg)
            return out

        mesh.barrier_all(axes)
        if "codec" in checks:
            a, b = (logits_of(build_policy("aggressive", backend=be))
                    for be in ("cuda", "ref"))
            check(all(_bits_equal(torch, x, y) for x, y in zip(a, b)),
                  f"dp {mesh_spec} rank {rank}: aggressive logits through "
                  f"the CUDA codec differ from the plain codec's")
            log(f"[dp {mesh_spec}] every rank: aggressive (qag int4 g32 "
                f"scale_int at every gather) prefill logits and "
                f"{DP_CHECK_STEPS} decode steps' logits through the CUDA "
                f"codec equal the plain codec's bit for bit", flush=True)
        if "fused" in checks:                  # held against the served run
            two_step = logits_of(build_policy("paper", scheme="two_step"))

        sites = _tp_sites(cfg)
        qag = _qag_gathers(cfg, plan)
        forwards = 1 + DP_PROMPT + DP_GEN - 1
        wire.reset_launches()                  # the dp path starts here
        stage.reset_launches()
        rdma.reset_launches()
        res["runs"] = {}
        for label, pol, scheme in runs:
            before = _tp_counts()
            torch.cuda.reset_peak_memory_stats()
            logits = []
            r = serve(store, cfg, plan, build_policy(pol, scheme=scheme),
                      batch=BATCH, prompt_len=DP_PROMPT, gen=DP_GEN,
                      device=dev, seed=SEED, label=f" dp {mesh_spec} {label}",
                      log=log, record=logits, **kw)
            got = {k: v - before[k] for k, v in _tp_counts().items()}
            want = dict.fromkeys(got, 0)
            gathers = qag if pol == "aggressive" else 0
            if scheme == "fused":
                want["ar"] = sites * forwards
            else:
                want["encode_wire"] = want["decode_wire"] = (
                    2 * sites + gathers) * forwards
            log(f"[dp {mesh_spec} {label}] rank {rank} launches "
                f"{ {k: v for k, v in got.items() if v} } (expected "
                f"{sites} TP sites x {2 if scheme != 'fused' else 1} and "
                f"{gathers} qag gathers x 1 a forward, {forwards} "
                f"forwards)", flush=True)
            check(got == want, f"dp {mesh_spec} rank {rank} {label}: "
                  f"launches {got} != {want}")
            check(r["agreement"] is not None, f"dp {mesh_spec} {label}: no "
                  f"prefill/decode check")
            check(all(bool(torch.isfinite(t).all()) for t in logits),
                  f"dp {mesh_spec} rank {rank} {label}: logits not finite")
            if "alone" in checks and label == "paper/two_step":
                torch.save({"logits": [t.cpu() for t in logits],
                            "generated": torch.from_numpy(
                                r["generated"][rows])},
                           os.path.join(out_dir, f"alone{rank}.pt"))
            if scheme == "fused":
                check(all(_bits_equal(torch, x, y)
                          for x, y in zip(logits, two_step)),
                      f"dp {mesh_spec} rank {rank}: paper/fused logits "
                      f"differ from paper/two_step's")
                log(f"[dp {mesh_spec}] every rank: paper/fused (fc_ar at "
                    f"the TP sites) prefill logits and {DP_CHECK_STEPS} "
                    f"decode steps' logits equal paper/two_step's bit for "
                    f"bit", flush=True)
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["launches"] = got
            res["runs"][label] = {k: (v.tolist() if hasattr(v, "tolist")
                                      else v) for k, v in r.items()}
        res["launches"] = _tp_counts()         # read right after the path
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        mesh.close_mesh(axes)
    return 0


def _dp_alone(torch, out_dir: str, data: int) -> None:
    """Check "alone" of phase dp: each replica's rows of the batch served
    alone at --mesh 1,1 from the whole store (fsdp = 1, the gather road:
    the flat values reshaped, no communication), the prompt teacher-forced
    and then the replica's generated tokens fed back, as its served
    paper/two_step run did -> every forward's logits bit-equal to that
    run's (saved by the replica's rank)."""
    from repro_torch.launch.serve import build_policy
    from repro_torch.parallel.plan import make_plan
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step, make_prefill)
    dev = torch.device("cuda")
    cfg = _dp_cfg()
    plan = make_plan(cfg, tp=1, fsdp=1)
    store = _dp_store(torch, cfg, plan, dev, 0, 0)
    policy = build_policy("paper")
    toks = torch.from_numpy(make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=DP_PROMPT, global_batch=BATCH,
        seed=SEED)).batch(0)["tokens"]).to(dev)
    prefill = make_prefill(cfg, plan, policy, flat=True)
    step = make_decode_step(cfg, plan, policy, flat=True)
    b_loc = BATCH // data
    steps = DP_PROMPT + DP_GEN - 1
    for r in range(data):
        saved = torch.load(os.path.join(out_dir, f"alone{r}.pt"))
        mine = toks[r * b_loc:(r + 1) * b_loc]
        fed = torch.cat([mine, saved["generated"].to(dev)], 1)
        got = [prefill(store, mine)]
        caches = make_cache_init(cfg, plan, b_loc, steps + 1, dev)()
        for i in range(steps):
            lg, caches = step(store, caches, fed[:, i:i + 1])
            got.append(lg)
        check(len(got) == len(saved["logits"]) and all(
            _bits_equal(torch, a.cpu(), b)
            for a, b in zip(got, saved["logits"])),
              f"dp replica {r}: logits at --mesh {data},1 differ from its "
              f"rows served alone at --mesh 1,1")
    del store
    print(f"[dp {data},1] paper/two_step: each replica's served logits "
          f"(prefill and {steps} decode steps) equal its rows' served "
          f"alone at --mesh 1,1 from the whole store (fsdp = 1) bit for "
          f"bit", flush=True)


def _dp_qag_time(torch, np, card: str) -> dict:
    """fc_encode_wire and fc_decode_wire at the largest qag shape of
    phase dp (qwen3-14b's embed/tok shard at fsdp = 2: one row of
    388,956,160 f32 values; its decode: the two replicas' wires to f32),
    aggressive's qag config, against their plain versions and the bound
    (3 calls a timing: the plain versions take 37-48 ms a call here)."""
    from repro_torch.core.policy import aggressive_policy
    from repro_torch.kernels import wire
    from repro_torch.models.model import param_groups
    from repro_torch.parallel.plan import make_plan
    cfg = _dp_cfg()
    plan = make_plan(cfg, tp=1, fsdp=2)
    spec = param_groups(cfg, plan)["embed"][1]["tok"]
    n = spec.flat_len(plan) // 2
    qcfg = aggressive_policy().resolve("qag")
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, n)).astype(np.float32) * 0.01).to(dev)
    buf = torch.cat([wire.encode_wire(x, qcfg)] * 2)
    label = "int4 g32 scale_int"
    rows = {}
    for name, r, kern, plain in (
            ("encode_wire", 1, lambda: wire.encode_wire(x, qcfg),
             lambda: wire.encode_plain(x, qcfg)),
            ("decode_wire", 2, lambda: wire.decode_wire(buf, qcfg, n),
             lambda: wire.decode_plain(buf, qcfg, n))):
        rows[name] = _time_row(torch, name, label, (r, n), kern, plain,
                               wire.bound_bytes(name, qcfg, r, n),
                               wire.bound_flops(name, qcfg, r, n), card,
                               runs=3)
    return rows


def _dp_ranks(torch, mesh_spec: str) -> list:
    """Phase dp's mesh ``mesh_spec``: one rank process a rank on the one
    card (dp_rank_main) -> their results."""
    from repro_torch.launch import mesh
    data, model = mesh.parse_mesh(mesh_spec)
    out_dir = os.path.join(ROOT, "chiprun_out", "dp")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, f))
    mesh.run_ranks(lambda r, store: [
        sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
        "--dp-mesh", mesh_spec, "--rendezvous", store, "--out", out_dir],
        data * model, timeout=DP_TIMEOUT_S)
    ranks = []
    for r in range(data * model):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if "alone" in DP_CELLS[mesh_spec][0]:
        _dp_alone(torch, out_dir, data)
    return ranks


def phase_dp(torch, np, card: str):
    """Data-parallel serving at --mesh D,M (DP_CELLS), one rank process a
    rank on the card, then the qag kernels' time at the largest gather
    shape -> (rank 0's launches over the served runs, the results)."""
    torch.cuda.empty_cache()                   # the earlier models are gone
    t0 = time.perf_counter()
    launches, out = {}, {}
    for mesh_spec, (_, runs) in DP_CELLS.items():
        t1 = time.perf_counter()
        ranks = _dp_ranks(torch, mesh_spec)
        out[mesh_spec] = ranks
        for k, v in ranks[0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for label, _, _ in runs:
            r0 = ranks[0]["runs"][label]
            check(all(r["runs"][label]["generated"] == r0["generated"]
                      for r in ranks), f"dp {mesh_spec} {label}: ranks "
                  f"hold different generated tokens")
            peaks = ", ".join(f"rank {r['rank']} "
                              f"{r['runs'][label]['peak_gb']:.2f}"
                              for r in ranks)
            rel = max(max(r["runs"][label]["agreement"]["rel_divergence"])
                      for r in ranks)
            print(f"[dp {mesh_spec} {label}] {_dp_cfg().name} "
                  f"({DP_LAYERS} layers, {BATCH} x {DP_PROMPT} prompt "
                  f"tokens + {DP_GEN}): TTFT {r0['ttft_ms']:.1f} ms, "
                  f"decode median {r0['step_ms_median']:.2f} ms/step, p90 "
                  f"{r0['step_ms_p90']:.2f} (rank 0's clock; {len(ranks)} "
                  f"ranks taking turns on one card, every step gathering "
                  f"the store over gloo); prefill/decode logit divergence "
                  f"{rel:.4f} (every replica); peak memory {peaks} GB  "
                  f"[{card}]", flush=True)
        print(f"[dp {mesh_spec}] {len(ranks)} rank processes done in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    out["qag_time"] = _dp_qag_time(torch, np, card)
    print(f"[dp] phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    # a rank process of phase tp, tp4, ep8 or rec (started by the phase)
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-tag", default="tp", help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    # a rank process of phase train (started by phase train itself)
    ap.add_argument("--train-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-mesh", help=argparse.SUPPRESS)
    ap.add_argument("--train-arch", default=TRAIN_ARCH,
                    help=argparse.SUPPRESS)
    # a rank process of phase dp (started by the phase)
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-mesh", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_tag, args.rendezvous,
                            args.out)
    if args.train_rank is not None:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        return train_rank_main(args.train_rank, args.train_mesh,
                               args.rendezvous, args.out, args.train_arch)
    if args.dp_rank is not None:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        return dp_rank_main(args.dp_rank, args.dp_mesh, args.rendezvous,
                            args.out)
    phases = args.phases.split(",")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_s = {}

    def run(name, fn, skipped):
        """Phase ``name`` (fn()) if it was asked for, else ``skipped``;
        its seconds printed and kept."""
        if name not in phases:
            return skipped
        t0 = time.perf_counter()
        res = fn()
        phase_s[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {phase_s[name]:.1f} s", flush=True)
        return res

    card = phase_build(torch)
    run("codec", lambda: phase_codec(torch, np), None)
    crc_timed = run("crc", lambda: phase_crc(torch, card), {})
    stage_launches = run("stage", lambda: phase_stage(torch, np), {})
    timing = run("time", lambda: phase_time(torch, np, card), {})
    launches, served = run("serve", lambda: phase_serve(torch, np), ({}, {}))
    ln_launches, ln_served = run("ln", lambda: phase_ln(torch, np), ({}, {}))
    a2a_launches, a2a_timed = run("a2a", lambda: phase_a2a(torch, card),
                                  ({}, {}))
    moe_launches, moe_served = run("moe", lambda: phase_moe(torch, np),
                                   ({}, {}))
    ar_launches, ar_timed = run("ar", lambda: phase_ar(torch, card), ({}, {}))
    tp_ranks = run("tp", lambda: phase_tp(torch, card), [])
    tp4_ranks = run("tp4", lambda: phase_tp(torch, card, "tp4"), [])
    trained = run("train", lambda: phase_train(torch, card), {})
    moe_trained = run("moe_train", lambda: phase_moe_train(torch, card), {})
    moe_archs_launches, moe_archs_served = run(
        "moe_archs", lambda: phase_moe_archs(torch, np, card), ({}, {}))
    ep8_ranks, ep8_trained = run("ep8", lambda: phase_ep8(torch, card),
                                 ([], {}))
    rec_launches, rec_out = run("rec", lambda: phase_rec(torch, np, card),
                                ({}, {}))
    xattn_launches, xattn_out = run(
        "xattn", lambda: phase_xattn(torch, np, card), ({}, {}))
    kinds_trained = run("kinds_train",
                        lambda: phase_kinds_train(torch, card), {})
    dp_launches, dp_out = run("dp", lambda: phase_dp(torch, np, card),
                              ({}, {}))
    ep8_launches = ep8_ranks[0]["ep"]["launches"] if ep8_ranks else {}
    ep8_train_launches = _train_launches(ep8_trained, EP_TRAIN_MESHES)
    train_launches = _train_launches(trained)
    moe_train_launches = _train_launches(moe_trained, TRAIN_MOE_MESHES)
    kinds_train_launches = _kinds_train_launches(kinds_trained)
    tp_launches = tp_ranks[0]["dense"]["launches"] if tp_ranks else {}
    moe_tp_launches = tp_ranks[0]["moe"]["launches"] if tp_ranks else {}
    glm_tp_launches = tp4_ranks[0]["glm"]["launches"] if tp4_ranks else {}

    main_cfg = {name: "int2 g32 spike" if name == "spike_pack"
                else "int8 g128" for name in REPLACES}
    kernels = []
    for name in WIRE_KERNELS + STAGE_KERNELS + ("a2a", "ar", "crc32c"):
        if name == "crc32c":
            t = crc_timed.get("pod site", {})
            errs = [t.get("max_abs_err")]
            source = "crc.cu"
            n = train_launches.get(name, 0)
        elif name == "a2a":
            t = a2a_timed.get(A2A_TIME_TP, {}).get("prefill", {})
            errs = [r["max_abs_err"] for by_shape in a2a_timed.values()
                    for r in by_shape.values()]
            source = "rdma.cu"
            n = (moe_tp_launches.get(name, 0)
                 + moe_train_launches.get(name, 0)
                 + ep8_launches.get(name, 0)
                 + ep8_train_launches.get(name, 0))
        elif name == "ar":
            t = ar_timed.get("prefill", {})
            errs = [r["max_abs_err"] for r in ar_timed.values()]
            source = "allreduce.cu"
            n = (tp_launches.get(name, 0) + moe_tp_launches.get(name, 0)
                 + glm_tp_launches.get(name, 0)
                 + train_launches.get(name, 0)
                 + moe_train_launches.get(name, 0)
                 + ep8_launches.get(name, 0)
                 + ep8_train_launches.get(name, 0)
                 + rec_launches.get(name, 0)
                 + xattn_launches.get(name, 0)
                 + kinds_train_launches.get(name, 0)
                 + dp_launches.get(name, 0))
        else:
            t = timing.get("prefill", {}).get(main_cfg[name], {}).get(
                name, {})
            errs = [r[name]["max_abs_err"] for by_cfg in timing.values()
                    for r in by_cfg.values() if name in r]
            source = "wire.cu" if name in WIRE_KERNELS else "stage.cu"
            n = (launches.get(name, 0) + ln_launches.get(name, 0)
                 + moe_launches.get(name, 0) + train_launches.get(name, 0)
                 + moe_train_launches.get(name, 0)
                 + moe_archs_launches.get(name, 0)
                 + rec_launches.get(name, 0)
                 + xattn_launches.get(name, 0)
                 + kinds_train_launches.get(name, 0)
                 + dp_launches.get(name, 0)
                 if name in WIRE_KERNELS else stage_launches.get(name, 0))
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": REPLACES[name], "launches": n,
            "serve_launches": launches.get(name, 0),
            "moe_launches": moe_launches.get(name, 0),
            "tp_launches": tp_launches.get(name, 0),
            "moe_tp_launches": moe_tp_launches.get(name, 0),
            "train_launches": train_launches.get(name, 0),
            "ln_launches": ln_launches.get(name, 0),
            "glm_tp_launches": glm_tp_launches.get(name, 0),
            "moe_train_launches": moe_train_launches.get(name, 0),
            "moe_archs_launches": moe_archs_launches.get(name, 0),
            "ep8_launches": ep8_launches.get(name, 0),
            "ep8_train_launches": ep8_train_launches.get(name, 0),
            "rec_launches": rec_launches.get(name, 0),
            "xattn_launches": xattn_launches.get(name, 0),
            "kinds_train_launches": kinds_train_launches.get(name, 0),
            "dp_launches": dp_launches.get(name, 0),
            "max_abs_err": max([e for e in errs if e is not None],
                               default=None),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": None})
    check(len(kernels) == len(REPLACES), f"kernels line: {len(kernels)}")

    def numbers(runs):
        return {k: {m: v for m, v in r.items()
                    if isinstance(v, (int, float, bool, dict))}
                for k, r in runs.items()}

    record = {"card": card, "phase_s": phase_s, "timing": timing,
              "launches": launches,
              "stage_launches": stage_launches, "a2a": a2a_timed,
              "a2a_launches": a2a_launches, "moe_launches": moe_launches,
              "serve": numbers(served), "moe": numbers(moe_served),
              "ar": ar_timed, "ar_launches": ar_launches, "tp": tp_ranks,
              "train": trained, "crc": crc_timed, "ln": numbers(ln_served),
              "tp4": tp4_ranks,
              "moe_train": moe_trained,
              "moe_archs": {a: numbers(r) for a, r in
                            moe_archs_served.items()},
              "moe_archs_launches": moe_archs_launches,
              "ep8": ep8_ranks, "ep8_train": ep8_trained,
              "rec": {k: v if k == "tp" else numbers(v)
                      for k, v in rec_out.items()},
              "rec_launches": rec_launches,
              "xattn": {k: v if k == "tp" else numbers(v)
                        for k, v in xattn_out.items()},
              "xattn_launches": xattn_launches,
              "kinds_train": kinds_trained,
              "kinds_train_launches": kinds_train_launches,
              "dp": dp_out, "dp_launches": dp_launches}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s "
          f"(numbers in chiprun_out/chip_smoke.json)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
