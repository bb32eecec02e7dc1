#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA
GPU and check it.

    python3 chip_smoke.py [--out DIR] [--profile] [--only PHASE,...]

Phases, one line (or a few) of output each:

  1 card       the card's name and power limit (nvidia-smi), torch and
               CUDA
  2 build      nvcc builds all nine kernels from src/repro_torch/csrc
               (sm_90a), one process per source, all started together
  3 kernels    each CUDA kernel against its plain PyTorch version on the
               card, at the main path's shapes; median times (CUDA events)
               of the kernel, the plain version and one PyTorch library
               call (cuDNN nn.LSTM / nn.GRU / nn.LSTMCell, torch.matmul,
               F.scaled_dot_product_attention) as a yardstick;
               lstm_decode and gru_decode (one cluster of up to 16 CTAs
               per batch row) at L=5 H=340, L=10 H=1024 and L=3 H=50 (plain
               loads), B = 1, 4, 5, 8, bf16 and fp32 W, fp32 U under bf16
               W and bf16 state: every call one launch, bit-equal run to
               run, across B and between a graph replay and the eager
               call, the kernel's cluster size equal to decode_splits',
               its occupancy; then timed as the serving tick runs them (a
               CUDA graph of chained ticks: BYSDNE's weights from L2,
               H = 1024's alternating between two stacks from HBM; B = 4
               and 1) beside the plain version and cuDNN (fp32 and bf16
               weights) in the same graphs; lstm_seq and
               gru_seq (one cluster of up to 16 CTAs per recurrence and
               group of 4 rows, U in shared memory) also with int8 U, with
               row-compacted U and with both, at a BYSDNE int8 wavefront
               slot, and at H = 1024 (fp32, bf16, int8 U: U streamed) and
               2048, each case printing its S, rows a cluster, U resident
               or streamed and the clusters the card holds; bit for bit
               run to run, rows of B=4 against B=1 calls, G=5 against G=1,
               packed rows against solo calls, a graph replay against the
               eager call and a walk chunked 8+8+8+5 against one launch;
               timed eager and in CUDA graphs of 20 launches (the
               serving slot and each weight branch), and at
               DeepBench's (1024, 25) slot beside cuDNN; lstm_cell (a
               CTA per 8 hidden units over the whole card) at H = 50, 340,
               1024 and 4096, B = 1, 4, 5, fp32 and bf16 U and
               activations, bit-equal run to run, across B, between a
               graph replay and the eager call and across the TPU tile,
               its split equal to cell_split's, then timed warm and eager
               and as the per_step chain runs it (150 launches in one CUDA
               graph: BYSDNE's 5 U's at H = 340, 8 U's from HBM at H =
               1024) beside the plain version and nn.LSTMCell (input
               width 1; fp32 and bf16 weights) in the same graphs;
               rglru_scan (a CTA per strip of 8-32 channels walking T in
               tiles) at the rglru phase's shape, at ragged W = 33, 100,
               513 and at T = 1 and each strip width's tile edges,
               bit-equal run to run, across
               B and between one call and T split over two calls, then
               timed at B = 4 (eager) and at B = 1, T = 256, 1024, 2048
               (CUDA graphs of repeated launches); mvm (one
               thread-block cluster per 64-column stripe, X split across
               its CTAs) at the RecurrentGemma-2B decode projections (bf16,
               B = 1..4) and at ragged shapes that reach the split's edges
               (fp32 and bf16, with and without bias), bit-equal run to run
               and across B, its clusters' occupancy, then timed warm per
               projection (B = 4 and 1), and cold over the decode step's
               156 projections on distinct weights (4.0 GB, one CUDA
               graph; also per shape) beside torch.matmul and the 1.20 ms
               bound; decode_attention (one cluster of 16 CTAs per row
               and kv head, taking the ring's 32-slot tiles in turn) at
               its attention layers' decode (bf16, B = 4, T = 2048, 10
               query heads on 1 kv head of 256, mixed valid, a full ring,
               and the edge valid counts of its tiles at B = 4 and B = 1),
               an fp32 GQA shape and the scalar-load D = 20, bit-equal run
               to run, across B and between a graph replay and the eager
               call, then timed cold in CUDA graphs on distinct rings from
               HBM (kernel, plain version and SDPA alike; B = 4 and 1;
               full, mixed and ~70-slot rings) and warm and eager; then
               both at the decoders' full-width shapes (serve_dense's,
               serve_moe's and serve_xlstm's archs): mvm at every (X, N)
               of their decode steps up to 29568 x 8192 (arctic's 7168
               x 7168, xLSTM's 768-wide shapes; B = 4 and 2, bit-equal run
               to run and across B) and decode_attention at every (Hk, G,
               D) on 4096-slot rings (D = 120's CUDA-core by_heads branch,
               D = 160, G = 12, G = 1, arctic's G = 7) and on the rings
               serve_dense and serve_moe decode on (512 slots
               at B = 4 and 1, 72 at B = 2; full rings and the tiles' edge
               valid counts), each against its plain version, then timed
               cold in CUDA graphs on distinct weights / rings beside
               torch.matmul / SDPA, with each arch's mvm step summed
  4 serve      RecurrentServingEngine serves the paper's BYSDNE LSTM (L=5,
               H=X=340, bf16 weights from a seeded torch.Generator): 6
               requests in two admission waves, then decode ticks; every
               launch must be a kernel launch, one lstm_decode per tick,
               no degraded launch; outputs held against a device="cpu"
               engine
  5 forward    rnn.compile(EESEN).forward (bidirectional, L=5, H=340,
               fp32) at B=4, T=300 under the card's device model
               (core.tiling.device_model: one G=2 lstm_seq launch a layer
               at bt300, which the TPU's VMEM budget refuses; the CPU
               plans the reference's 200 launches at bt8); launches ==
               plan.launches; output held against the CPU path; then,
               outside the counted run, the guarded ladder on the card: an
               injected fused fault recovers through per-step kernel
               launches, one past per-step raises; then the plan beside
               ExecutionPolicy(block_t=8) (the bt8 plan), outputs held
               together, warm walls in turns (model, bt8, bt8, model) x3
  6 paper      the paper's H=1024 networks at full width through the main
               path under the card's model, weights from a seeded
               generator at PAPER_GAIN x the fan-in init: RLDRADSPR (L=10,
               fp32) forward at B=4, T=400 as an LSTM and as a GRU stack
               (lstm_seq / gru_seq launches == plan.launches, no degraded
               launch); GMAT (L=17, bf16 weights) served by
               RecurrentServingEngine(max_batch=4): 4 prompts of 75
               frames, 8 decoded frames each, one chained lstm_decode
               launch a tick over the 17 layers; each held against the CPU
               path (verify="off" under the reference's model) within
               TOL_E2E and a share of its max |ref| (TOL_REL), and the
               same stack with its last layer skipped planted against
               that check, which it must fail; each plan's (schedule, bt, launches) and warm wall;
               then one lstm_seq launch of 16 rows at H=1024 over 132,096
               steps, whose element offsets pass 2^31, bit for bit against
               the same walk in 8 launches whose offsets stay below 2^31
  7 serve_gru  the same 6 requests through BYSDNE as a GRU
               (rnn_family="gru", bf16 weights): gru_seq + gru_decode
               launches == the plans' launches, one gru_decode per tick,
               no degraded launch; outputs held against the CPU engine
  8 offpath    off the packed timeline: the per_step BYSDNE LSTM forward
               (B=4, T=30: 150 lstm_cell launches == plan.launches); a
               mixed lstm/gru/lstm/gru stack at H=340 (forward, then one
               decode tick resumed from its prefill state: 4 launches);
               the "unfolded" research schedule (plain PyTorch, zero
               kernel launches); each held against the CPU path
  9 rglru      one RG-LRU layer of RecurrentGemma-2B at full width (W =
               2560, B = 4, T = 2048, random weights from a seeded
               torch.Generator): gate_inputs, then dispatch.execute of an
               L=1 rglru item — one rglru_scan launch == plan.launches;
               held against the device="cpu" path; the model's L=18 item
               stays plan-only; a mixed plan of one BYSDNE LSTM item and
               one rglru item runs in one execute
 10 precision  BYSDNE as an LSTM and as a GRU (bf16 weights, layer l's U
               with every 8-row tile t, t % (l + 2) == 0, zeroed) under
               ExecutionPolicy(precision="int8", sparsity="block") at B=4,
               T=30: forward, prefill, then decode ticks resumed from the
               prefill state; then int8 alone and bf16 + block sparsity,
               forward; launches == the plans' launches in every run, each
               output held against the CPU path
 11 serve_lm   serving.ServingEngine serves RecurrentGemma-2B at full width
               (26 layers, d_model 2560, vocab 256000, bf16 weights drawn
               on the card from a seeded torch.Generator; max_batch 4,
               max_seq 4096: 2048-slot rings) 6 requests of 5, 37, 300,
               1100, 2100 and 64 prompt tokens, 16 new tokens each: every
               decode step launches 156 mvm and 8 decode_attention
               kernels, every prefill 18 rglru_scan, and no plain version
               runs; the decode step is a CUDA graph per batch size (the
               batched tick, the batch-1 remainder step), captured after
               its first eager step and replayed for every later one, and
               each replay counts the launches it holds; the logits of
               every generated token held against a teacher-forced forward
               on the card; two requests served again with a fault planted
               in each decode kernel's call (mvm loses a k-tile,
               decode_attention the newest slot), which that check must
               see; decode_attention on a clone of the engine's own cache
               at its first batched tick on a wrapped ring (8 layers, rows
               of mixed valid) against its plain version; each attention
               layer of the decode step against the teacher-forced forward
               on the same input (F3: the block's output within TOL_LAYER
               at every decoded position of every request), which must
               also catch both planted faults; the first three layers
               served on the card and by a device="cpu" engine; then a
               warm run: the first replay at
               each batch size held bit for bit against the step run
               eagerly, each step's host wall and device span (CUDA
               events), whose ratio gives the host-overhead share; then one
               more replay at each batch size under torch.profiler, whose
               kernels, counted on the device by name, must equal the
               launches the replay counted, and whose device time over
               the median span gives the device's busy share; with
               --profile, also 8 batched ticks and the 64- and 2048-token
               prefills under torch.profiler, each prefill's rglru_scan
               device ms and launches (18, one a rglru layer)
 12 serve_dense the reference's six dense decoders at full width, one on
               the card at a time (bf16 weights drawn on the card from a
               seeded torch.Generator): stablelm-12b, starcoder2-3b and
               h2o-danube-3-4b whole, deepseek-67b cut to 24 of its 95
               layers (DENSE_RUNS: a depth chosen to keep the phase
               short; each arch's peak device memory is printed) through
               serving.ServingEngine(max_batch=4): four prompts of 5-300
               tokens, 8 new each (512-slot full-length rings), and for
               h2o-danube first an 8,200-token prompt (its 8192 bucket
               through local_attention and the roll into the 4096-slot
               window ring; the first wave's batched ticks on the wrapped
               ring); every decode step 6 L mvm and L decode_attention
               launches, no plain version; every step after the first at
               a batch size a graph replay; each request's logits within
               TOL_LM of a teacher-forced forward on the card; for
               stablelm-12b and h2o-danube each attention layer of the
               decode step against the forward (F3, over stacked views);
               the first 2 layers against a device="cpu" engine; each
               arch's wall, median replayed tick (host wall, device span)
               and device busy share in one profiled replay.  Then
               musicgen-large whole and qwen2-vl-72b cut to 16 of 80
               layers: transformer.prefill on seeded embeddings (B=2, 64
               positions; qwen2-vl's with three distinct (t, h, w) M-RoPE
               position streams), 8 decode_steps (6 L mvm and L
               decode_attention launches each) against one forward over
               the whole sequence (TOL_EMBEDS)
 13 serve_moe  the MoE decoders at full width, one on the card at a time
               (bf16 weights drawn on the card, the stacked expert leaves
               expert by expert into their slices): olmoe-1b-7b whole
               (16 layers, 64 experts top-8), arctic-480b cut to 2 of 35
               layers (MOE_RUNS: 128 experts top-2 and the dense branch,
               27.2 GB a layer); through serving.ServingEngine(max_batch=
               4) with serve_dense's four prompts, 8 new each, twice.
               Drop-free (capacity factor 64): serve_lm's checks, every
               decode step 3 L mvm (6 L with arctic's dense branch) and L
               decode_attention launches, every later step a replay; each
               request's logits against a teacher-forced forward that
               routes every token to the experts the engine picked (the
               routing read back from each prefill, eager step and graph
               replay, _RouteLog), within TOL_MOE (olmoe) or TOL_LM
               (arctic); where that forward's own top-k would differ,
               each such pick within FLIP_GAP of its k-th probability;
               a control that both limits must see (the forward with a
               wrong expert planted at one layer); olmoe's first 2 layers
               against a device="cpu" engine; the replayed tick's medians
               and busy share.  Then at the config's capacity factor
               1.25: the routing invariants on the card for every routed
               call (each (expert, slot) held once, loads min(demand, C),
               weights summing to <= 1, to 1 without drops) and each
               prefill's dropped picks printed; each model's peak memory
 14 serve_xlstm xlstm-125m whole (12 layers alternating mLSTM / sLSTM, d
               768) through ServingEngine(max_batch=4): prompts of 5, 37,
               140, 300 and 2100 tokens (buckets 4-128 through the
               recurrent mLSTM prefill, 256 and 2048 the chunkwise one), 8
               new each, twice; every decode step 48 mvm launches (6 an
               mLSTM layer, 2 an sLSTM layer), every later step a replay.
               As the reference's init draws it, sLSTM's R at 1/sqrt(H)
               makes the recurrence chaotic: one bf16 ulp on the inputs
               moves the forward's logits by their own size within a few
               tokens (printed), so the logits are printed, not held, and
               each layer of the decode step is held against the
               forward's on the same input and state, one step at a time
               at every decoded position, and for two requests against
               the same step on the CPU (TOL_LAYER); the replayed tick's
               medians and busy share.  Then with every R at 1/sqrt(dh),
               where rounding does not grow along the sequence (the
               one-ulp response and the fp32 forward printed): each
               request's logits within TOL_XLSTM of the teacher-forced
               forward, the first 2 layers against a device="cpu" engine,
               and two planted faults (mvm loses a k-tile; the slot
               splice drops the mLSTM memory) that check must see
 15 train      training (P11) on the card.  rglru_scan_bwd (the RG-LRU
               scan's backward: a CTA per strip of 8-32 channels walking
               T backwards in tiles) against its plain version at the
               train step's shape (B = 1, T = 1024, W = 2560), B = 4 T =
               2048 and each strip width's tile edges at ragged widths:
               within 1e-6 of the largest |plain|, the same inf and nan,
               bit-equal run to run and each row against its own B = 1
               call; timed in a CUDA graph of 20 launches and eager beside
               the plain version and the bytes bound.  RecurrentGemma-2B
               whole at full width (bf16 weights drawn on the card, fp32
               AdamW moments) through launch.steps.make_train_step at B =
               1, T = 1024 and, where the peak leaves room, 2048 (the data
               pipeline's "random" source): a warm step and 3 timed steps
               each, every loss finite, 18 rglru_scan and 18
               rglru_scan_bwd launches a step and no plain version; step
               ms (CUDA events, host wall), tokens/s, peak memory; one
               more step under torch.profiler (its top device operations,
               the two kernels' device ms and counts, the busy share).
               The first 3 layers (rglru, rglru, attn) at full width: one
               step on the card against the same step on the chip
               machine's CPU (B = 1, T = 64; loss, every gradient leaf,
               every updated parameter within TOL_TRAIN_*), and again with
               rglru_scan_bwd's dlog_a zeroed, which that check must fail.
               common.matmul_f32's backward at olmoe's expert shape
               against the fp32 products.  Every reduced arch of the
               registry in fp32 and in bf16 (the MoE experts' and sLSTM's
               bf16 products and their backward, the routing, the xLSTM
               scans): one make_train_step on the card against the CPU.
               runtime.TrainLoop on recurrentgemma-2b reduced with int8
               compression and a fault at step 9: the final state equal
               to an uninterrupted run's bit for bit
 16 calib      the measured cost model (repro_torch.calib) on the card:
               replays what EESEN (B=4, T=300) and BYSDNE as an LSTM and a
               GRU launch (prefill slots; the decode tick's chained and
               per-layer sides at B = 4, 2, 1), EESEN's G=2 and G=1 slots
               at the other stripes the planner weighs and its bt300 slot,
               and the smoke grid, into a table tagged cuda(<card>) under
               --out (a temporary directory without it): each signature's
               med / p90 us (CUDA events around the eager call) and
               analytic cycles; every replay one kernel launch, no plain
               version, no other tag in the table, check_table within 25x;
               the per_step price (lstm_seq G=1 bt1) beside lstm_cell's
               eager us; then rnn.compile(EESEN) forward under the
               measured policy (launches == plan.launches, output against
               the analytic plan's, both plans, their warm walls in turns,
               the model's us for the chosen plan and for a bt300 plan);
               the serve and serve_gru checks under the measured policy; a
               copy of the table with every chained signature 1000x dearer
               flips BYSDNE's decode tick to 5 lstm_seq launches (no
               lstm_decode), within TOL_FP32 of the chained tick; and
               `python -m repro_torch.calib --grid smoke --check 25` exits 0
 17 figures    the rows of benchmarks/paper_tables.py from the port's
               core.perfmodel (the paper's ASIC cycle model, host
               arithmetic): Fig. 9's best K per MAC budget, Fig. 10's max
               and at-512 speedups, Fig. 11's model speedups, Fig. 12's
               latency and utilization per budget, Table 4 and Table 6
               "ours" beside the paper's values, Fig. 14's energy
               reduction and GFLOPS/W; then Fig. 11's measured half on the
               card (fig11/measured_card/h256/<schedule>): the five
               core.schedules.LAYER_FNS at H=256, T=25, B=1, fp32, from
               seeded generators, fused one lstm_seq launch and the four
               research schedules none, each output held against the same
               function on the CPU, timed by runtime.obs.measure_us in
               turns (3 rounds of 10 calls), with each schedule's speedup
               against sequential
 18 chaos      the chaos suite's isolation scenarios at BYSDNE's width
               (L=5, H=X=340, bf16 weights) through RecurrentServingEngine(
               device="cuda", on_fault="fallback"): a prefill fault that
               bisects a 3-request wave, a poisoned prefill state, a
               poison at decode tick 2 with max_batch 2, a max-ticks
               deadline; each scenario's statuses and counters equal a
               device="cpu" engine's given the same scenario, lstm_seq /
               lstm_decode launches equal the engine's packed_launches /
               decode_launches and no plain version runs; each co-batched
               request (and a faulted request's kept frames) against the
               fault-free card run: max |diff| printed, held bit for bit
 19 mesh       the port's sharding (repro_torch.sharding) on the card:
               starcoder2-3b whole (bf16) on a 1x1 DeviceMesh("cuda",
               ("data", "model")) over NCCL at world size 1, params by
               param_specs(fsdp=False), rings by cache_specs: prefills of
               4 prompts of 24-300 tokens, then 8 decode_steps at B=4,
               logits and rings bit for bit equal to the same steps with
               no mesh, every step 6 L mvm and L decode_attention
               launches (counted, and on the device in one step
               profiled in a fresh process), ticks timed with and
               without the mesh; the
               reduced starcoder2-3b train step on the 1x1 mesh, loss,
               params and AdamW moments bit for bit equal to the step
               with no mesh; then two ranks sharing the card (two
               processes on cuda:0, gloo on CUDA tensors; NCCL refuses two
               ranks on one device): run_layer_unfolded_tp (H=340, B=4,
               T=300, gate axis over model=2) within TOL_TP of the 1-rank
               run_layer_unfolded on the card, and the reduced
               starcoder2-3b decode with its ring's T split over model=2
               (each rank's decode_attention on its half, the (m, l)
               combine) within TOL_SEQ of the 1-rank card decode
 20 cost       the static cost walker (repro_torch.calib.hlo) against
               the card at full width, eager: starcoder2-3b's and
               olmoe-1b-7b's B=4 decode steps on 4096-slot rings and
               RecurrentGemma-2B's B=1 T=1024 train step, each traced on
               the host first (fake tensors of the card's arguments),
               then run on the card: the trace's kernel ops equal the
               counted launches; its FLOPs outside the kernels equal
               FlopCounterMode's of the card's step and its kernel FLOPs
               the launches' Cost; the card's path of the train step
               computes 8 B T d V FLOPs more than the function (the
               unembed's three bf16 products a cotangent); its predicted
               high-water mark within COST_PEAK_REL + COST_PEAK_ABS of
               max_memory_allocated's growth; its bound at most
               COST_BOUND_SHARE x the step's CUDA-event time
 21 summary    one JSON line {"kernels": [...]} with each kernel's (and
               each lstm_seq / gru_seq weight branch's) launches, max
               error, times and bound (each bound from the kernel's
               Cost: kernels.common.Cost)

With --profile, the serve, forward, paper, serve_gru and precision
phases also print their lstm_seq / gru_seq device ms (paper's GMAT serve
its lstm_decode ms too), and offpath its per_step forward's lstm_cell
device ms, and each checks the profiled launches against the counted
run's.

The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before it.  The script imports nothing of JAX and nothing of the
JAX package; it needs a CUDA card and the CUDA toolkit (nvcc).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PHASES = ("card", "build", "kernels", "serve", "forward", "paper",
          "serve_gru", "offpath", "rglru", "precision", "serve_lm",
          "serve_dense", "serve_moe", "serve_xlstm", "train", "calib",
          "figures", "chaos", "mesh", "cost", "summary")
#: kernel entry point -> the TPU kernel it replaces
KERNELS = {
    "lstm_seq": "src/repro/kernels/lstm_cell/kernel.py:205",
    "lstm_decode": "src/repro/kernels/lstm_cell/kernel.py:337",
    "lstm_cell": "src/repro/kernels/lstm_cell/kernel.py:76",
    "gru_seq": "src/repro/kernels/gru_cell/kernel.py:111",
    "gru_decode": "src/repro/kernels/gru_cell/kernel.py:217",
    "rglru_scan": "src/repro/kernels/rglru/kernel.py:40",
    "mvm": "src/repro/kernels/mvm_tile/kernel.py:49",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:63",
    # no TPU kernel: jax.grad differentiates the reference's lax.scan
    "rglru_scan_bwd": "src/repro/models/layers/rglru.py:50",
}
#: entry points whose source file (csrc/<name>.cu) has another name
SOURCES = {"mvm": "mvm_tile"}
#: the sequence kernels' weight branches (kernels.common.seq_variant): a
#: summary row each, "lstm_seq" for dense U, "lstm_seq[int8]" and so on
VARIANTS = ("dense", "int8", "compact", "int8+compact")
SEQ_KERNELS = ("lstm_seq", "gru_seq")


def row_name(kernel: str, variant: str = "dense") -> str:
    return kernel if variant == "dense" else f"{kernel}[{variant}]"


#: summary rows: (row name — also the ctx key of its measurements —,
#: kernel source)
ROWS = tuple((row_name(k, v), k) for k in KERNELS
             for v in (VARIANTS if k in SEQ_KERNELS else ("dense",)))


# max |kernel - plain| on identical inputs.  fp32 activations: the kernel
# and cuBLAS/PyTorch sum the 340 h.U products in different orders, and the
# difference compounds over the recurrence; bf16 activations: one bf16
# rounding of |h| < 1 is up to 2^-8 and can flip between the two.
TOL_FP32 = 1e-4
TOL_BF16 = 2e-2
# bf16 outputs of a kernel and its plain version that sum the same fp32
# products in other orders: one bf16 ulp of the largest output (2^-7
# relative), since a sum near a rounding midpoint may round either way.
# decode_attention takes it per (row, query head), of that head's largest
# output: its heads' outputs differ in scale by orders of magnitude (a
# head with one live slot returns v itself)
ULP_BF16 = 2.0 ** -7
# end to end against the CPU path (different GEMM libraries as well, over
# up to 300 steps x 5 layers)
TOL_E2E = 1e-3
# serve_lm, fp32 logits of the bf16 RecurrentGemma-2B (|logit| up to ~5
# at this init).  Against the teacher-forced forward (26 layers): the
# decode step and the forward round to bf16 at other points (mvm and
# cuBLAS sum in other orders, so an output can round to the neighbouring
# bf16 value, 2^-8 relative; the decode kernel keeps p in fp32 where the
# prefill paths round it to bf16), and such one-ulp differences enter at
# each of the 26 residual adds and travel to the logits: a few percent of
# their range, 0.25.  The JAX package's own bf16 decode differs from its
# own forward for the same reasons.  Depth 3, the card against the CPU
# engine: the same code with other summation orders and exp
# implementations, over 3 residual layers: 0.1.
TOL_LM = 0.25
TOL_LM_DEPTH3 = 0.1
# serve_moe, olmoe-1b-7b's drop-free logits against the forward routed as
# served: its 16 layers of experts drawn at 1/sqrt(E) carry the decode
# step's and the forward's other rounding points further than serve_lm's
# 26 dense layers (on an H100 the sound runs' largest difference is
# 0.256), and a wrong expert lands far beyond it: the heaviest pick of
# every token at one layer sent to the expert its router ranks last is
# planted against this limit in every run (_moe_flips), which must fail
# it (1.95 on an H100).  The other MoE archs are held at TOL_LM.
TOL_MOE = {"olmoe-1b-7b": 0.4}
# serve_xlstm, xlstm-125m's served logits against the teacher-forced
# forward, with sLSTM's R at 1/sqrt(dh) (_xlstm_serve): there, on an
# H100, the bf16 forward itself lies up to 0.49 from the fp32 forward of
# the same weights, and moves by up to 0.52 when its input embeddings
# move by one bf16 ulp, at every prompt length alike (printed by
# _xlstm_fp32 and _xlstm_horizon): the served path, which rounds at other
# points, is held to that size of rounding (its largest difference is
# 0.333); two planted faults must land beyond it in every run (4.4 and
# 4.9, _xlstm_planted).
TOL_XLSTM = 0.5
# serve_lm, each attention layer of the decode step against the
# teacher-forced forward on the same input (_attn_layers_vs_forward): the
# attention block's bf16 output at a decoded position, within 2^-6 of
# that position's largest |output|, four bf16 ulps: q, k and v (mvm
# against cuBLAS) may each round to the neighbouring bf16 value, the
# forward rounds p to bf16 where the kernel keeps it in fp32 (2^-9), and
# the core and w_o's output round once more; each of those four is at
# most one ulp (2^-8) of the values it feeds, which a projection carries
# to its output at the same relative size.  A dropped slot among ~70 live
# ones moves the core by ~1/sqrt(70), ~12%, of its size.
TOL_LAYER = 2.0 ** -6
# serve_lm, a graph replay of the decode step against the same step run
# eagerly on the same inputs: the same kernels in the same order, so bit
# for bit (_replay_vs_eager)
TOL_REPLAY = 0.0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps: int, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events on the current stream (after a warm-up
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, trials: int = 5) -> float:
    """Median over ``trials`` of one replay of ``fn`` captured in a CUDA
    graph, timed with CUDA events around the replay (after a warm-up
    call): the device's time for the work, without the host's time to
    enqueue it, as the decode step runs it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    del graph
    return statistics.median(out)


def max_err(outs, refs) -> float:
    return max(float((o.float() - r.float()).abs().max())
               for o, r in zip(outs, refs))


def device_events(fn):
    """Run ``fn`` under torch.profiler: (host wall in us, device time in us
    by kernel name, device events by kernel name)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    count = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
    return wall_us, by_name, count


def profile_breakdown(fn, label: str):
    """Run ``fn`` once more under torch.profiler and print the device's
    busy share of the wall time and its time by kernel (the run's
    breakdown for PERF.md; ``--profile`` only).  Returns the device time
    and events by kernel name."""
    wall_us, by_name, count = device_events(fn)
    busy = sum(by_name.values())
    if not busy:
        print(f"{label}: profile: the profiler saw no device time")
        return by_name, count
    top = "; ".join(f"{name[:48]} {us / 1e3:.2f} ms ({count[name]})"
                    for name, us in by_name.most_common(8))
    ours = []
    for kernel in DEVICE_NAMES:
        ms, k = device_share(by_name, count, kernel)
        ours.append(f"{kernel} {ms:.3f} ms ({k}"
                    + (f", {ms / k:.4f} ms each)" if k else ")"))
    print(f"{label}: profile: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 - 100 * busy / wall_us:.1f}%; {sum(count.values())} device "
          f"events; by kernel (events): {top}; the port's cluster and scan "
          f"kernels: {'; '.join(ours)}")
    return by_name, count


def _profiled_launches(label, kernel, by_name, count, launches):
    """A profiled rerun's ``kernel`` events on the device against the
    launches the counted run made (the same plan)."""
    ms, n = device_share(by_name, count, kernel)
    print(f"{label}: profile: {kernel} {ms:.3f} ms of device in {n} "
          f"launches (the counted run launched {launches})")
    check(n == launches, f"{label}: the profiler saw {n} {kernel} kernels "
                         f"for {launches} launches")


def device_share(by_name, count, kernel):
    """(device ms, events) of the port's ``kernel`` in a profile."""
    return (sum(us for n, us in by_name.items() if is_kernel(kernel, n))
            / 1e3, sum(c for n, c in count.items() if is_kernel(kernel, n)))


def bound(nbytes: float, flops: float, rate: str = "fp32"):
    """The least ms of a function: its bytes over the H100's HBM rate or
    its operations over its peak ``rate`` ("fp32" or "bf16"), the larger
    (``repro_torch.configs.base.H100``, NVIDIA's data sheet, dense, at the
    700 W limit: the recurrent kernels' operands are fp32, or upcast to
    it; the bf16 rate bounds the operations on bf16 operands, mvm and
    decode_attention on the decoders' paths)."""
    from repro_torch.configs.base import H100

    peak = {"fp32": H100.peak_flops_fp32, "bf16": H100.peak_flops_bf16}
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = flops / peak[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def meta(*shape, dtype=None):
    """A ``meta`` tensor (shape and dtype, no storage; fp32 by default):
    what a kernel's ``Cost`` is priced on."""
    import torch

    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def cost_bound(cost, rate: str = "fp32"):
    """``bound`` of a kernel's ``Cost`` (``kernels.common.Cost``): its
    bytes, or its FLOPs and other operations."""
    return bound(cost.bytes, cost.ops, rate)


def entries():
    """Every kernel entry point of the port (each carries its counters)."""
    from repro_torch import kernels

    return (kernels.lstm_seq, kernels.lstm_decode, kernels.lstm_cell,
            kernels.gru_seq, kernels.gru_decode, kernels.rglru_scan,
            kernels.mvm, kernels.decode_attention, kernels.rglru_scan_bwd)


def tally(ctx, *fns) -> None:
    """Add the kernel launches ``fns`` counted since their last reset to
    the summary's rows (the sequence kernels by weight branch)."""
    for fn in fns:
        if fn.__name__ in SEQ_KERNELS:
            check(sum(fn.variant_launches.values()) == fn.kernel_launches,
                  f"{fn.__name__}: branch counts disagree with its launches")
            for variant, n in fn.variant_launches.items():
                ctx["launches"][row_name(fn.__name__, variant)] += n
        else:
            ctx["launches"][fn.__name__] += fn.kernel_launches


# ---------------------------------------------------------------------------


def phase_card(ctx):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    ctx["card"] = line
    print(line)
    print(f"card: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")


def phase_build(ctx):
    from repro_torch.kernels import build as kernel

    t0 = time.perf_counter()
    secs = kernel.build()
    wall = time.perf_counter() - t0
    ctx["build_s"] = secs
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" (parallel, {wall:.1f} s wall) into {kernel.BUILD_DIR}")
    for name in secs:
        log = kernel.build_log(name)
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not ln.strip().startswith(
                             "0 bytes stack frame, 0 bytes spill")})
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"  {name}: {len(regs)} kernel instances; registers: "
              f"{sorted(set(r.split(',')[0] for r in regs))}; "
              f"non-zero spills: {spills or 'none'}")
        if ctx["out"]:
            with open(os.path.join(ctx["out"], f"{name}.ptxas.log"),
                      "w") as f:
                f.write(log)


def _seq_case(G, B, T, H, u_dtype, act_dtype, seed, dev, gates=4):
    """(U, xw, h0, c0) of a sequence kernel; the GRU's takes the first
    three (gates=3)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    U = (torch.randn((G, H, gates, H), generator=g) * H ** -0.5
         ).to(u_dtype)
    xw = torch.randn((G, B, T, gates, H), generator=g).to(act_dtype)
    h0 = (torch.randn((G, B, H), generator=g) * 0.5).to(act_dtype)
    c0 = torch.randn((G, B, H), generator=g) * 0.5
    return [t.to(dev) for t in (U, xw, h0, c0)]


def _decode_case(L, B, H, w_dtype, seed, dev, gates=4, u_dtype=None,
                 h_dtype=None):
    """(xw0, Ws, bs, Us, h0, c0) of a decode kernel, drawn on the card from
    a seeded generator; the GRU's takes the first five (gates=3).  U in
    W's type unless ``u_dtype``; xw0 and h0 fp32 unless ``h_dtype``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    s = H ** -0.5
    hd = h_dtype or torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    Ws = (randn(L, H, gates, H) * s).to(w_dtype)
    Ws[0] = float("nan")  # the kernel never reads layer 0's W
    bs = (randn(L, gates, H) * 0.1).to(w_dtype)
    Us = (randn(L, H, gates, H) * s).to(u_dtype or w_dtype)
    xw0 = randn(B, gates, H).to(hd)
    h0 = (randn(L, B, H) * 0.5).to(hd)
    c0 = randn(L, B, H) * 0.5
    return [xw0, Ws, bs, Us, h0, c0]


def phase_kernels(ctx):
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.lstm_cell import ops

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    H = 340
    seq_err = 0.0
    # the main path's lstm_seq shapes: EESEN's fwd+bwd slots (G=2, B=4,
    # bt=8, fp32), BYSDNE's admission-wave slots (bf16 U, fp32 xw/h, G up
    # to 5, ragged B, remainder chunks of 5), and bf16 activations
    cases = [(2, 4, 8, f32, f32, None), (5, 4, 8, bf16, f32, [4, 3, 4, 1, 1]),
             (1, 1, 5, bf16, f32, None), (2, 2, 30, f32, f32, [2, 1]),
             (3, 4, 8, bf16, bf16, [4, 2, 1])]
    for i, (G, B, T, ud, ad, b_valid) in enumerate(cases):
        U4, xw, h0, c0 = _seq_case(G, B, T, H, ud, ad, seed=i, dev=dev)
        mask = None if b_valid is None else ragged_b_mask(G, B, b_valid, dev)
        ref = ops.lstm_seq_plain(U4, xw, h0, c0, mask)
        out = ops.lstm_seq(U4, xw, h0, c0, b_valid=b_valid)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = TOL_FP32 if ad == f32 else TOL_BF16
        print(f"kernels: lstm_seq G={G} B={B} T={T} H={H} U={ud} act={ad} "
              f"b_valid={b_valid}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"{_seq_shape('lstm', B, H, U4)}")
        check(err <= tol, f"lstm_seq disagrees with its plain version: "
                          f"{err:.3e} > {tol:g}")
        if ad == f32:
            seq_err = max(seq_err, err)
    # a remainder walk: chunks 8+8+8+5 chained through h_T/c_T against the
    # plain version over the whole T=29
    U4, xw, h0, c0 = _seq_case(2, 4, 29, H, f32, f32, seed=7, dev=dev)
    ref = ops.lstm_seq_plain(U4, xw, h0, c0)
    outs, h, c = [], h0, c0
    for t0 in range(0, 29, 8):
        o, h, c = ops.lstm_seq(U4, xw[:, :, t0:t0 + 8], h, c, block_t=8)
        outs.append(o)
    err = max_err((torch.cat(outs, 2), h, c), ref)
    print(f"kernels: lstm_seq chunked 8+8+8+5 vs one plain walk T=29: "
          f"max_abs_err {err:.3e} (tol {TOL_FP32:g})")
    check(err <= TOL_FP32, "chunked lstm_seq walk disagrees")
    seq_err = max(seq_err, err)

    # ---- times at the main path's most frequent shapes -------------------
    torch.backends.cudnn.allow_tf32 = False  # cuDNN LSTM in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    G, B, T = 2, 4, 8  # EESEN forward slot: one bidirectional layer chunk
    U4, xw, h0, c0 = _seq_case(G, B, T, H, f32, f32, seed=11, dev=dev)
    k_ms = median_ms(lambda: ops.lstm_seq(U4, xw, h0, c0), reps=20)
    p_ms = median_ms(lambda: ops.lstm_seq_plain(U4, xw, h0, c0), reps=20)
    lstm = torch.nn.LSTM(H, H, num_layers=1, batch_first=True,
                         bidirectional=True).to(dev)
    x = torch.randn((B, T, H), device=dev)
    with torch.no_grad():
        l_ms = median_ms(lambda: lstm(x), reps=20)
    b_ms, b_by = cost_bound(ops.lstm_seq_cost(U4, xw, h0, c0))
    ctx["lstm_seq"] = dict(max_abs_err=seq_err, ms=k_ms, plain_ms=p_ms,
                           library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                           shape=f"G={G} B={B} T={T} H={H} fp32")
    print(f"kernels: lstm_seq at G={G} B={B} T={T} H={H} fp32: kernel "
          f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
          f"{p_ms:.4f} ms, nn.LSTM (cuDNN, bidirectional, input "
          f"GEMM included) {l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; a "
          f"chain of {T} steps, so latency, not bytes, is the floor)")

    _kernels_decode(ctx, dev, "lstm")
    _kernels_gru(ctx, dev)
    _kernels_cell(ctx, dev)
    _kernels_seq_variants(ctx, dev)
    for family in ("lstm", "gru"):
        _seq_bits(dev, family)
        _seq_wide(ctx, dev, family)
        _seq_times(ctx, dev, family)
    _kernels_rglru(ctx, dev)
    _kernels_mvm(ctx, dev)
    _kernels_decode_attention(ctx, dev)
    _kernels_dense(ctx, dev)


def _kernels_gru(ctx, dev):
    """gru_seq against its plain version, then timed; then gru_decode
    (``_kernels_decode``)."""
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.gru_cell import ops

    f32, bf16 = torch.float32, torch.bfloat16
    seq_err = 0.0
    # the GRU serve's gru_seq shapes at H=340 (bf16 U, fp32 xw/h, G up to
    # 5, ragged B, remainder chunks), fp32 U, bf16 activations, and H=50:
    # 3H = 150 is not a multiple of four, so the scalar instantiation runs
    cases = [(1, 1, 5, 340, bf16, f32, None),
             (5, 4, 8, 340, bf16, f32, [4, 3, 4, 1, 1]),
             (5, 2, 4, 340, f32, f32, [2, 2, 1, 2, 1]),
             (2, 4, 8, 340, f32, f32, None),
             (3, 4, 8, 340, bf16, bf16, [4, 2, 1]),
             (2, 3, 9, 50, f32, f32, [3, 1]),
             (1, 4, 6, 50, bf16, bf16, None)]
    for i, (G, B, T, H, ud, ad, b_valid) in enumerate(cases):
        U3, xw, h0, _ = _seq_case(G, B, T, H, ud, ad, seed=20 + i, dev=dev,
                                  gates=3)
        mask = None if b_valid is None else ragged_b_mask(G, B, b_valid, dev)
        ref = ops.gru_seq_plain(U3, xw, h0, mask)
        out = ops.gru_seq(U3, xw, h0, b_valid=b_valid)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = TOL_FP32 if ad == f32 else TOL_BF16
        print(f"kernels: gru_seq G={G} B={B} T={T} H={H} U={ud} act={ad} "
              f"b_valid={b_valid}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"{_seq_shape('gru', B, H, U3)}")
        check(err <= tol, f"gru_seq disagrees with its plain version: "
                          f"{err:.3e} > {tol:g}")
        if ad == f32:
            seq_err = max(seq_err, err)
    # a remainder walk: chunks 8+8+8+5 chained through h_T against the
    # plain version over the whole T=29
    U3, xw, h0, _ = _seq_case(2, 4, 29, 340, bf16, f32, seed=30, dev=dev,
                              gates=3)
    ref = ops.gru_seq_plain(U3, xw, h0)
    outs, h = [], h0
    for t0 in range(0, 29, 8):
        o, h = ops.gru_seq(U3, xw[:, :, t0:t0 + 8], h, block_t=8)
        outs.append(o)
    err = max_err((torch.cat(outs, 2), h), ref)
    print(f"kernels: gru_seq chunked 8+8+8+5 vs one plain walk T=29: "
          f"max_abs_err {err:.3e} (tol {TOL_FP32:g})")
    check(err <= TOL_FP32, "chunked gru_seq walk disagrees")
    seq_err = max(seq_err, err)

    # ---- times: a GRU serve slot (two recurrences, bf16 U) -------------
    H = 340
    G, B, T = 2, 4, 8
    U3, xw, h0, _ = _seq_case(G, B, T, H, bf16, f32, seed=31, dev=dev,
                              gates=3)
    k_ms = median_ms(lambda: ops.gru_seq(U3, xw, h0), reps=20)
    p_ms = median_ms(lambda: ops.gru_seq_plain(U3, xw, h0), reps=20)
    gru = torch.nn.GRU(H, H, num_layers=1, batch_first=True,
                       bidirectional=True).to(dev)
    x = torch.randn((B, T, H), device=dev)
    with torch.no_grad():
        l_ms = median_ms(lambda: gru(x), reps=20)
    b_ms, b_by = cost_bound(ops.gru_seq_cost(U3, xw, h0))
    ctx["gru_seq"] = dict(max_abs_err=seq_err, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                          shape=f"G={G} B={B} T={T} H={H} bf16 U, fp32 "
                                f"xw/h")
    print(f"kernels: gru_seq at G={G} B={B} T={T} H={H} bf16 U: kernel "
          f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
          f"{p_ms:.4f} ms, nn.GRU (cuDNN, fp32, bidirectional, "
          f"input GEMM included) {l_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}; a chain of {T} steps, so latency is the floor)")

    _kernels_decode(ctx, dev, "gru")


#: the decode kernels' widths (L, H): BYSDNE's, RLDRADSPR's (L = 10, H =
#: 1024) and H = 50, whose slices take plain loads (H % 4 != 0); the
#: batches each is held against its plain version at; the operand forms
#: (W, U, h and xw0 dtypes; None: U in W's type), the last two at B = 4
DECODE_WIDTHS = ((5, 340), (10, 1024), (3, 50))
DECODE_BATCHES = (1, 4, 5, 8)
DECODE_FORMS = (("bf16 W", "bfloat16", None, "float32"),
                ("fp32 W", "float32", None, "float32"),
                ("bf16 W, fp32 U", "bfloat16", "float32", "float32"),
                ("bf16 W, bf16 h", "bfloat16", None, "bfloat16"))
#: chained ticks in one timed CUDA graph: on one stack at BYSDNE's width
#: (its 8.5 MB stay in L2, as between serving ticks), and alternating
#: between two stacks at H = 1024 (160 MB each, so every tick reads its
#: weights from HBM)
DECODE_TICKS = {340: (20, 1), 1024: (4, 2)}


def _decode_family(family):
    """(entry point, plain version, gates) of the ``family`` decode
    kernel."""
    if family == "lstm":
        from repro_torch.kernels.lstm_cell import ops
        return ops.lstm_decode, ops.lstm_decode_plain, 4
    from repro_torch.kernels.gru_cell import ops
    return ops.gru_decode, ops.gru_decode_plain, 3


def _decode_outs(out):
    return out if isinstance(out, tuple) else (out,)


def _decode_row(args, r):
    """A decode call's operands cut to batch row r (B = 1)."""
    xw0, Ws, bs, Us, *state = args
    return [xw0[r:r + 1], Ws, bs, Us] + [t[:, r:r + 1] for t in state]


def _decode_bound(gates, L, B, H):
    """The least time of one tick with bf16 weights and fp32 state, from
    the decode kernels' Cost (``kernels.common.decode_cost``): W_1..
    W_(L-1), U_0..U_(L-1) and b_1..b_(L-1) read once, xw0, h0 (and c0)
    read and h_n (and c_n) written once; 2 gates H^2 FMAs per row and
    matrix."""
    import torch

    from repro_torch.kernels.common import decode_cost

    bf16 = torch.bfloat16
    return cost_bound(decode_cost(
        gates, meta(B, gates, H), meta(L, H, gates, H, dtype=bf16),
        meta(L, gates, H, dtype=bf16), meta(L, H, gates, H, dtype=bf16),
        meta(L, B, H)))


def _chained(fn, xw0, stacks, state, n):
    """n decode ticks, tick t on stacks[t % len(stacks)], the state of
    each tick feeding the next."""
    for t in range(n):
        Ws, bs, Us = stacks[t % len(stacks)]
        state = _decode_outs(fn(xw0, Ws, bs, Us, *state))
    return state


def _cudnn_ms(mods, x, state, n):
    """cuDNN's multi-layer nn.LSTM / nn.GRU at T = 1, the state chained
    over n calls (module t % len(mods)): (ms a call, method) — a CUDA
    graph of the n calls, or, where cuDNN's RNN cannot be captured, CUDA
    events around the n calls run back to back; (None, reason) where the
    module refuses the inputs."""
    import torch

    def run():
        st = state
        for t in range(n):
            _, st = mods[t % len(mods)](x, st)

    with torch.no_grad():
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as err:
            return None, f"refused: {str(err).splitlines()[0][:80]}"
        try:
            return graph_ms(run) / n, "graph"
        except RuntimeError as err:
            torch.cuda.synchronize()
            why = str(err).splitlines()[0][:80]
            return median_ms(run, reps=1) / n, f"events (no capture: {why})"


def _kernels_decode(ctx, dev, family):
    """``family``'s decode kernel against its plain version at
    DECODE_WIDTHS x DECODE_BATCHES in DECODE_FORMS; every call one launch,
    bit-equal run to run, each row of a batch bit-equal to its B = 1 call,
    a graph replay bit-equal to the eager call; its clusters' occupancy;
    then timed (``_decode_times``)."""
    import torch

    from repro_torch.kernels.common import (decode_clusters, decode_splits,
                                            reset_counts)

    fn, plain, gates = _decode_family(family)
    name = fn.__name__
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    err_max, seed = 0.0, 200 if family == "lstm" else 300
    for L, H in DECODE_WIDTHS:
        for B in DECODE_BATCHES:
            for form, wd, ud, hd in DECODE_FORMS:
                if form in ("bf16 W, fp32 U", "bf16 W, bf16 h") and B != 4:
                    continue
                seed += 1
                args = _decode_case(L, B, H, dts[wd], seed, dev, gates,
                                    u_dtype=dts.get(ud), h_dtype=dts[hd])
                args = args if family == "lstm" else args[:5]
                ref = _decode_outs(plain(*args))
                reset_counts(fn)
                out = _decode_outs(fn(*args))
                again = _decode_outs(fn(*args))
                rows = [_decode_outs(fn(*_decode_row(args, r)))
                        for r in range(B)] if B > 1 else []
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if hd == "float32" else TOL_BF16
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                batch = all(torch.equal(o[:, r], x[:, 0])
                            for r, row in enumerate(rows)
                            for o, x in zip(out, row))
                n = fn.kernel_launches
                print(f"kernels: {name} L={L} B={B} H={H} {form}, "
                      f"{'bf16' if hd == 'bfloat16' else 'fp32'} state (S="
                      f"{decode_splits(H, gates)}): max_abs_err {err:.3e} "
                      f"(tol {tol:g}); two runs bit-equal {same}; rows == "
                      f"their B=1 calls {batch if B > 1 else 'n/a'}; "
                      f"launches {n}")
                check(err <= tol, f"{name} disagrees with its plain version "
                                  f"({form}, B={B}, H={H}): {err:.3e}")
                check(same and batch, f"{name} L={L} B={B} H={H} {form}: not "
                                      "bit-equal run to run or across B")
                check(n == 2 + len(rows), f"{name}: {n} launches for "
                                          f"{2 + len(rows)} calls")
                if hd == "float32":
                    err_max = max(err_max, err)
        # a CUDA graph's replay is the eager call
        args = _decode_case(L, 4, H, torch.bfloat16, seed, dev, gates)
        args = args if family == "lstm" else args[:5]
        eager = _decode_outs(fn(*args))
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            replayed = _decode_outs(fn(*args))
        graph.replay()
        torch.cuda.synchronize()
        replay = all(torch.equal(a, b) for a, b in zip(replayed, eager))
        del graph
        print(f"kernels: {name} L={L} B=4 H={H} bf16 W: a CUDA graph's "
              f"replay == the eager call {replay}")
        check(replay, f"{name} H={H}: a graph replay differs from the "
                      "eager call")
        for B in (1, 4):
            S, n_cl = decode_clusters(family, B, H)
            print(f"kernels: {name} H={H} B={B}: clusters of S={S} CTAs "
                  f"(decode_splits {decode_splits(H, gates)}), one a row; "
                  f"cudaOccupancyMaxActiveClusters {n_cl}")
            check(S == decode_splits(H, gates) and n_cl > 0,
                  f"{name} H={H}: the kernel's cluster size {S} is not "
                  f"decode_splits', or its cluster does not fit ({n_cl})")
    ctx[name] = dict(max_abs_err=err_max)
    _decode_times(ctx, dev, family)


def _decode_times(ctx, dev, family):
    """``family``'s decode kernel timed as the serving tick runs it: a CUDA
    graph of chained ticks (DECODE_TICKS) at BYSDNE's width (L = 5, H =
    340) and RLDRADSPR's (L = 10, H = 1024), bf16 weights and fp32 state,
    B = 4 and 1; the plain version and cuDNN's nn.LSTM / nn.GRU (fp32
    weights, and bf16 where cuDNN takes them; layer 0's input GEMM
    included) alike; then warm and eager at BYSDNE's B = 4, as the earlier
    eager timings did.  The bound is the HBM bound of a cold tick at both
    widths, while BYSDNE's chained ticks read their weights from L2."""
    import torch

    fn, plain, gates = _decode_family(family)
    name = fn.__name__
    f32, bf16 = torch.float32, torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's RNN in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    rnn = torch.nn.LSTM if family == "lstm" else torch.nn.GRU
    times = ctx.setdefault(f"{name}_times", {})
    for L, H in DECODE_WIDTHS[:2]:
        n, n_stacks = DECODE_TICKS[H]
        cases = [_decode_case(L, 4, H, bf16, 400 + i, dev, gates)
                 for i in range(n_stacks)]
        stacks = [tuple(c[1:4]) for c in cases]
        mods = {dt: [rnn(H, H, num_layers=L, batch_first=True).to(dev, dt)
                     for _ in range(n_stacks)] for dt in (f32, bf16)}
        for B in (4, 1):
            xw0, h0, c0 = (cases[0][0][:B].contiguous(),
                           cases[0][4][:, :B].contiguous(),
                           cases[0][5][:, :B].contiguous())
            state = (h0, c0) if family == "lstm" else (h0,)

            def ticks(f):
                return lambda: _chained(f, xw0, stacks, state, n)

            k_ms = graph_ms(ticks(fn)) / n
            p_ms = graph_ms(ticks(plain), trials=3) / n
            lib = {}
            for dt in (f32, bf16):
                x = torch.randn((B, 1, H), device=dev, dtype=dt)
                st = tuple(t.to(dt) for t in state)
                lib[dt] = _cudnn_ms(mods[dt], x,
                                    st if family == "lstm" else st[0], n)
            bd_ms, bd_by = _decode_bound(gates, L, B, H)
            times[f"B{B} L{L} H{H}"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib[f32][0],
                library_method=lib[f32][1], library_bf16_ms=lib[bf16][0],
                library_bf16_method=lib[bf16][1], bound_ms=bd_ms,
                bound_by=bd_by)
            cu = ", ".join(
                f"{t} " + (f"{ms:.4f} ({how})" if ms is not None else how)
                for t, (ms, how) in (("fp32 W", lib[f32]),
                                     ("bf16 W", lib[bf16])))
            print(f"kernels: {name} tick at L={L} B={B} H={H} bf16 W, fp32 "
                  f"state, one CUDA graph of {n} chained ticks on "
                  f"{n_stacks} stack(s), ms a tick: kernel {k_ms:.4f}, plain "
                  f"{p_ms:.4f}; {rnn.__name__} (cuDNN, layer-0 input GEMM included) "
                  f"{cu}; bound {bd_ms:.6f} ({bd_by}); kernel / bound "
                  f"{k_ms / bd_ms:.2f}")
        del cases, stacks, mods
        torch.cuda.empty_cache()
    # warm and eager at BYSDNE's B = 4 (the earlier eager condition)
    L, H = DECODE_WIDTHS[0]
    args = _decode_case(L, 4, H, bf16, 420, dev, gates)
    args = args if family == "lstm" else args[:5]
    w_ms = median_ms(lambda: fn(*args), reps=50)
    print(f"kernels: {name} warm and eager at L={L} B=4 H={H} bf16 W: "
          f"kernel {w_ms:.4f} ms")
    row = times[f"B4 L{L} H{H}"]
    ctx[name].update(
        ms=row["ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], warm_ms=w_ms,
        condition=f"L={L} B=4 H={H} bf16 W, fp32 state; ms, plain_ms and "
                  f"library_ms (cuDNN fp32, {row['library_method']}) a tick "
                  f"of {DECODE_TICKS[H][0]} chained ticks in one CUDA graph "
                  "with the weights warm in L2, warm_ms warm and eager; "
                  "bound_ms the HBM bound of a cold tick")


#: lstm_cell's widths, each taken apart differently by its split: H = 50
#: (plain loads; the last CTA holds 2 of its 8 units), BYSDNE's 340 (8-byte
#: bf16 vectors; the last CTA 4 units), RLDRADSPR's 1024 and 4096 (16-byte
#: bf16 vectors; 4096 lies past the sequence kernels' limit); its operand
#: forms (U, then xw and h dtypes), each at B = 1, 4 and 5
CELL_WIDTHS = (50, 340, 1024, 4096)
CELL_FORMS = (("float32", "float32"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16"))
#: the per_step schedule's chain of launches as one CUDA graph: (distinct
#: U's, launches on one before the next) -- BYSDNE's 5 layers of 30 steps,
#: layer after layer (each U warm in L2 after its first step); at H = 1024
#: the launches cycle through 8 U's (67 MB, past the 50 MB L2), so each
#: launch reads its U from HBM
CELL_CHAINS = {340: (5, 30), 1024: (8, 1)}
CELL_CHAIN_LAUNCHES = 150


def _cell_case(B, H, u_dtype, act_dtype, seed, dev):
    """(U4, xw_t, h_prev, c_prev) of lstm_cell, drawn on the card from a
    seeded generator: U scaled by H^-1/2, c_prev fp32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return [(randn(H, 4, H) * H ** -0.5).to(u_dtype),
            randn(B, 4, H).to(act_dtype), (randn(B, H) * 0.5).to(act_dtype),
            randn(B, H) * 0.5]


def _cell_bound(B, H, u_bytes):
    """The least time of one step, from the cell kernel's Cost
    (``lstm_cell_cost``): U read once, xw, h and c read and h, c written
    once (fp32), 8 H^2 + 14 H operations a row at the fp32 rate."""
    import torch

    from repro_torch.kernels.lstm_cell.ops import lstm_cell_cost

    u_dtype = torch.bfloat16 if u_bytes == 2 else torch.float32
    return cost_bound(lstm_cell_cost(meta(H, 4, H, dtype=u_dtype),
                                     meta(B, 4, H), meta(B, H), meta(B, H)))


def cell_chain_ms(fn, Us, xws, h, c, order) -> float:
    """ms a launch of ``fn(U, xw_t, h, c) -> (h, c)`` chained over
    ``order`` (the index into ``Us`` of each launch; launch i takes
    ``xws[i]``, and h and c feed forward), the chain captured in one CUDA
    graph, as the per_step schedule runs it (``graph_ms``)."""

    def run():
        hh, cc = h, c
        for i, l in enumerate(order):
            hh, cc = fn(Us[l], xws[i], hh, cc)

    return graph_ms(run) / len(order)


def _cell_chains(dev):
    """lstm_cell as the per_step schedule runs it (CELL_CHAINS): one CUDA
    graph of CELL_CHAIN_LAUNCHES launches at B = 4, bf16 U and fp32 xw, h,
    c, at H = 340 and 1024; then the plain version and nn.LSTMCell (fp32
    and bf16 weights) in the same kind of graph.  nn.LSTMCell takes an
    input of width 1, so its input GEMM reads 4H weights and it moves the
    kernel's bytes: one U-sized recurrent matrix a step.  Returns {H:
    {label: ms a launch, "bound": ms}}."""
    import torch

    from repro_torch.kernels.lstm_cell import ops

    B, n = 4, CELL_CHAIN_LAUNCHES
    out = {}
    for H, (n_u, run) in CELL_CHAINS.items():
        Us = [_cell_case(1, H, torch.bfloat16, torch.float32, 600 + i,
                         dev)[0] for i in range(n_u)]
        order = [i // run % n_u for i in range(n)]
        g = torch.Generator(device=dev).manual_seed(700 + H)
        xws = torch.randn((n, B, 4, H), generator=g, device=dev)
        h = torch.randn((B, H), generator=g, device=dev) * 0.5
        c = torch.randn((B, H), generator=g, device=dev) * 0.5
        times = {"kernel": cell_chain_ms(ops.lstm_cell, Us, xws, h, c,
                                         order),
                 "plain": cell_chain_ms(ops.lstm_cell_plain, Us, xws, h, c,
                                        order)}
        x = torch.randn((n, B, 1), generator=g, device=dev)
        for dt, label in ((torch.float32, "nn.LSTMCell fp32"),
                          (torch.bfloat16, "nn.LSTMCell bf16")):
            mods = [torch.nn.LSTMCell(1, H).to(dev, dt) for _ in range(n_u)]
            with torch.no_grad():
                times[label] = cell_chain_ms(
                    lambda m, x_t, hh, cc: m(x_t, (hh, cc)), mods, x.to(dt),
                    h.to(dt), c.to(dt), order)
            del mods
        b_ms, b_by = _cell_bound(B, H, 2)
        times["bound"] = b_ms
        out[H] = times
        print(f"kernels: lstm_cell per_step chain at B={B} H={H} bf16 U, "
              f"fp32 xw/h/c, one CUDA graph of {n} launches on {n_u} U's "
              f"({run} in a row), ms a launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                          if k != "bound")
              + f"; bound {b_ms:.6f} ({b_by})")
        del Us, xws
        torch.cuda.empty_cache()
    return out


def _kernels_cell(ctx, dev):
    """lstm_cell (a CTA per 8 hidden units over the whole card) against its
    plain version at CELL_WIDTHS x CELL_FORMS x B = 1, 4, 5; bit-equal run
    to run, across B, between a graph replay and the eager call and across
    the TPU tile (block_h, block_k); one launch a call; the C side's split
    equal to cell_split's; then timed warm and eager at the per_step
    BYSDNE step and in the per_step chain's CUDA graphs."""
    import torch

    from repro_torch.kernels.common import (cell_shape, cell_smem,
                                            cell_split, reset_counts)
    from repro_torch.kernels.lstm_cell import ops

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cell_err, seed = 0.0, 50
    for H in CELL_WIDTHS:
        for ud, ad in CELL_FORMS:
            u_dtype, a_dtype = dts[ud], dts[ad]
            sp = cell_split(H, u_dtype.itemsize)
            for B in (1, 4, 5):
                seed += 1
                args = _cell_case(B, H, u_dtype, a_dtype, seed, dev)
                ref = ops.lstm_cell_plain(*args)
                reset_counts(ops.lstm_cell)
                out = ops.lstm_cell(*args)
                again = ops.lstm_cell(*args)
                rows = [ops.lstm_cell(args[0], *(t[r:r + 1]
                                                 for t in args[1:]))
                        for r in range(B)] if B > 1 else []
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if ad == "float32" else TOL_BF16
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                batch = all(torch.equal(o[r:r + 1], x)
                            for r, row in enumerate(rows)
                            for o, x in zip(out, row))
                n = ops.lstm_cell.kernel_launches
                shape = cell_shape(B, H, u_dtype)
                want = dict(ctas_x=sp["ctas"], ctas_y=-(-B // 4),
                            V=sp["V"], KG=sp["KG"],
                            smem=cell_smem(H, u_dtype.itemsize, B))
                print(f"kernels: lstm_cell B={B} H={H} U={ud} act={ad}: "
                      f"grid {shape['ctas_x']}x{shape['ctas_y']} CTAs, V="
                      f"{shape['V']}, KG={shape['KG']}, smem "
                      f"{shape['smem']} B; max_abs_err {err:.3e} (tol "
                      f"{tol:g}); two runs bit-equal {same}; rows == their "
                      f"B=1 calls {batch if B > 1 else 'n/a'}; launches {n}")
                check(err <= tol, f"lstm_cell disagrees with its plain "
                                  f"version (B={B} H={H} U={ud} act={ad}): "
                                  f"{err:.3e} > {tol:g}")
                check(same and batch, f"lstm_cell B={B} H={H}: not bit-equal "
                                      "run to run or across B")
                check(n == 2 + len(rows), f"lstm_cell: {n} launches for "
                                          f"{2 + len(rows)} calls")
                check(shape == want, f"lstm_cell B={B} H={H}: the kernel's "
                                     f"split {shape} is not cell_split's "
                                     f"{want}")
                if ad == "float32":
                    cell_err = max(cell_err, err)
    # the per_step BYSDNE step: a graph's replay, the TPU tile
    args = _cell_case(4, 340, torch.bfloat16, torch.float32, 55, dev)
    eager = ops.lstm_cell(*args)
    tiles = all(torch.equal(a, b) for bh, bk in ((128, 8), (8, 5), (340, 24))
                for a, b in zip(ops.lstm_cell(*args, block_h=bh,
                                              block_k=bk), eager))
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        replayed = ops.lstm_cell(*args)
    graph.replay()
    torch.cuda.synchronize()
    replay = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    del graph
    ctas = cell_split(340, 2)["ctas"]
    print(f"kernels: lstm_cell B=4 H=340 bf16 U: {ctas} CTAs; a CUDA "
          f"graph's replay == the eager call {replay}; block_h / block_k "
          f"change no bit {tiles}")
    check(replay and tiles and ctas >= 32,
          "lstm_cell: a graph replay or another TPU tile changed the "
          "output, or the split has fewer than 32 CTAs at H = 340")

    # warm and eager at the per_step BYSDNE step (the earlier condition)
    B, H = 4, 340
    U4, xw, h, c = args
    w_ms = median_ms(lambda: ops.lstm_cell(U4, xw, h, c), reps=100)
    wp_ms = median_ms(lambda: ops.lstm_cell_plain(U4, xw, h, c), reps=100)
    cell = torch.nn.LSTMCell(1, H).to(dev)
    x = torch.randn((B, 1), device=dev)
    with torch.no_grad():
        wl_ms = median_ms(lambda: cell(x, (h, c)), reps=100)
    print(f"kernels: lstm_cell warm and eager at B={B} H={H} bf16 U: kernel "
          f"{w_ms:.4f} ms, plain {wp_ms:.4f} ms, nn.LSTMCell (fp32, input "
          f"width 1) {wl_ms:.4f} ms")
    chains = _cell_chains(dev)
    b_ms, b_by = _cell_bound(B, H, 2)
    t, wide = chains[340], chains[1024]
    ctx["lstm_cell"] = dict(
        max_abs_err=cell_err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["nn.LSTMCell fp32"], bound_ms=b_ms, bound_by=b_by,
        warm_ms=w_ms, wide_ms=wide["kernel"], wide_bound_ms=wide["bound"],
        chains=chains,
        condition=f"B={B} H={H} bf16 U, fp32 xw/h/c; ms, plain_ms and "
                  f"library_ms (nn.LSTMCell(1, H), fp32 weights) a launch "
                  f"of the per_step chain's {CELL_CHAIN_LAUNCHES} launches "
                  "in one CUDA graph, on 5 U's 30 launches each, so 29 of "
                  "30 launches read U from L2, while bound_ms is a cold "
                  "step's HBM bound; warm_ms warm and eager; wide_ms the "
                  "same chain at H=1024 cycling 8 U's, each launch's U from "
                  "HBM, against wide_bound_ms")


def _weight_branch(U, variant: str, first_layer: int = 0):
    """(U, u_scales, u_rows) of one sequence-kernel weight branch for the
    G cells of U (G, H, gates, H): cell g stands for layer first_layer + g
    of the precision phase's stack, whose 8-row tiles t with
    t % (layer + 2) == 0 are zeroed (so the cells keep different row
    counts and a compacted launch pads them to one Ha); then U is
    quantized per gate ("int8") and/or row-compacted ("compact")."""
    import torch

    from repro_torch.kernels import quant

    G, H = U.shape[0], U.shape[1]
    U = U.float().clone()
    maps = []
    for g in range(G):
        keep = tuple(int(t % (first_layer + g + 2) != 0)
                     for t in range(-(-H // 8)))
        for t, bit in enumerate(keep):
            if not bit:
                U[g, t * 8:(t + 1) * 8] = 0.0
        maps.append(keep)
    scales = rows = None
    if "int8" in variant:
        q = [quant.quantize_per_gate(U[g]) for g in range(G)]
        U = torch.stack([u for u, _ in q])
        scales = torch.stack([sc for _, sc in q])
    if "compact" in variant:
        Ha = max(len(quant.active_row_indices(m, H)) for m in maps)
        c = [quant.compact_rows(U[g], maps[g], pad_to=Ha) for g in range(G)]
        U = torch.stack([u for u, _ in c])
        rows = torch.stack([r for _, r in c])
    return U, scales, rows


def _seq_bound(family, G, B, T, H, U, scales, rows):
    """Least time of one sequence-kernel launch with fp32 activations, from
    the sequence kernels' Cost (``kernels.common.seq_cost``): bytes (U in
    its stored type, its scales and row index, xw, state in and out, hs)
    or operations (the h·U products over the rows U holds, and the cell's
    pointwise work), whichever is larger."""
    from repro_torch.kernels.common import seq_cost

    gates = 4 if family == "lstm" else 3
    return cost_bound(seq_cost(gates, U, meta(G, B, T, gates, H),
                               meta(G, B, H), None, scales, rows))


def _seq_family(family):
    """(gates, entry point, plain version) of the ``family`` sequence
    kernel."""
    if family == "lstm":
        from repro_torch.kernels.lstm_cell import ops
        return 4, ops.lstm_seq, ops.lstm_seq_plain
    from repro_torch.kernels.gru_cell import ops
    return 3, ops.gru_seq, ops.gru_seq_plain


def _seq_shape(family, B, H, U) -> str:
    """What the C side takes for a ``family`` sequence launch at (B, H,
    U's rows and type): S, rows a cluster, U resident or streamed, shared
    memory a CTA and clusters the card holds at once (at least one); S and
    the shared memory held against kernels.common.seq_splits / seq_smem."""
    from repro_torch.kernels.common import seq_shape, seq_smem, seq_splits

    gates = 4 if family == "lstm" else 3
    args = (H, gates, U.element_size(), U.shape[1])
    sh = seq_shape(family, B, H, U.shape[1], U.dtype)
    check((sh["S"], sh["smem"]) == (seq_splits(*args), seq_smem(*args))
          and sh["clusters"] >= 1,
          f"{family}_seq H={H} B={B}: the kernel's launch {sh} is not "
          f"seq_splits' / seq_smem's, or the card holds none of its "
          f"clusters")
    where = ("resident" if not sh["ring"] else
             f"streamed through a {sh['ring']} B ring")
    return (f"S={sh['S']} R={sh['R']}, U {where}, {sh['smem']} B shared a "
            f"CTA, {sh['clusters']} clusters at once")


def _graph_ms_each(fn, n=20) -> float:
    """ms a call of ``fn`` in one CUDA graph of ``n`` calls, so that
    launch latency does not hide the kernel."""
    return graph_ms(lambda: [fn() for _ in range(n)]) / n


#: the bit-for-bit checks' cases: (H, U dtype, weight branch), each at
#: G = 5, B = 4, T = 29 with fp32 activations
SEQ_BIT_CASES = ((340, "float32", "dense"), (340, "bfloat16", "dense"),
                 (340, "float32", "int8+compact"), (1024, "float32", "dense"),
                 (1024, "bfloat16", "dense"), (50, "float32", "dense"))


def _seq_bits(dev, family):
    """The sequence kernel's fixed sum order, bit for bit at each
    SEQ_BIT_CASES case: two runs; each row of a B=4 call against its B=1
    call; each recurrence of a G=5 call against its G=1 call; a packed
    call (b_valid) whose valid rows equal the full call's and whose masked
    rows keep h0 (and c0); a CUDA graph's replay against the eager call;
    and the walk chunked 8+8+8+5 through h_T (and c_T) against one launch
    over T=29."""
    import torch

    gates, seq, _ = _seq_family(family)
    name = f"{family}_seq"
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    G, B, T = 5, 4, 29

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for i, (H, ud, variant) in enumerate(SEQ_BIT_CASES):
        U, xw, h0, c0 = _seq_case(G, B, T, H, dts[ud], torch.float32,
                                  seed=500 + i, dev=dev, gates=gates)
        sc = rows = None
        if variant != "dense":
            U, sc, rows = _weight_branch(U, variant, first_layer=0)
        st = [h0, c0] if family == "lstm" else [h0]

        def run(u, x, state, **kw):
            return seq(u, x, *state, u_scales=kw.pop("sc", sc),
                       u_rows=kw.pop("rows", rows), **kw)

        full = run(U, xw, st)
        ok = {"run to run": same(full, run(U, xw, st))}
        ok["rows of B=4 == B=1 calls"] = all(
            same([o[:, b:b + 1] for o in full],
                 run(U, xw[:, b:b + 1], [t[:, b:b + 1] for t in st]))
            for b in range(B))
        ok["G=5 == G=1 calls"] = all(
            same([o[g:g + 1] for o in full],
                 run(U[g:g + 1], xw[g:g + 1], [t[g:g + 1] for t in st],
                     sc=None if sc is None else sc[g:g + 1],
                     rows=None if rows is None else rows[g:g + 1]))
            for g in range(G))
        b_valid = [4, 3, 2, 1, 4]
        packed = run(U, xw, st, b_valid=b_valid)
        ok["packed rows == solo"] = all(
            torch.equal(p[g, :n], f[g, :n])
            for p, f in zip(packed, full) for g, n in enumerate(b_valid))
        ok["masked rows keep the state"] = all(
            torch.equal(packed[0][g, b], h0[g, b][None].expand(T, H))
            and all(torch.equal(p[g, b], s[g, b])
                    for p, s in zip(packed[1:], st))
            for g, n in enumerate(b_valid) for b in range(n, B))
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            replayed = run(U, xw, st)
        graph.replay()
        torch.cuda.synchronize()
        ok["graph replay == eager"] = same(replayed, full)
        del graph
        outs, state = [], st
        for t0 in range(0, T, 8):
            o, *state = run(U, xw[:, :, t0:t0 + 8], state, block_t=8)
            outs.append(o)
        ok["8+8+8+5 == one launch"] = same([torch.cat(outs, 2)] + state,
                                           full)
        torch.cuda.synchronize()
        print(f"kernels: {name} bits at G={G} B={B} T={T} H={H} U={ud} "
              f"{variant}: " + "; ".join(f"{k} {v}" for k, v in ok.items())
              + f" ({_seq_shape(family, B, H, U)})")
        check(all(ok.values()), f"{name} H={H} U={ud} {variant}: not bit "
                                f"for bit: {ok}")


#: the sequence kernels' widest cases, held against the plain version:
#: (G, B, T, H, U dtype, weight branch) -- DeepBench's (1024, 25) slot of
#: the paper's sweep in three U types, its widest H, and a launch of 10
#: clusters at H = 340, more than the card holds at once (waves)
SEQ_WIDE = ((1, 4, 25, 1024, "float32", "dense"),
            (1, 4, 25, 1024, "bfloat16", "dense"),
            (1, 4, 25, 1024, "float32", "int8"),
            (1, 4, 8, 2048, "bfloat16", "dense"),
            (5, 8, 8, 340, "float32", "dense"))


def _seq_wide(ctx, dev, family):
    """SEQ_WIDE against the plain version (fp32 activations, TOL_FP32);
    the errors join their summary rows' max_abs_err."""
    import torch

    gates, seq, plain = _seq_family(family)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, (G, B, T, H, ud, variant) in enumerate(SEQ_WIDE):
        U, xw, h0, c0 = _seq_case(G, B, T, H, dts[ud], torch.float32,
                                  seed=520 + i, dev=dev, gates=gates)
        sc = rows = None
        if variant != "dense":
            U, sc, rows = _weight_branch(U, variant, first_layer=0)
        st = (h0, c0) if family == "lstm" else (h0,)
        ref = plain(U, xw, *st, None, sc, rows)
        out = seq(U, xw, *st, u_scales=sc, u_rows=rows)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        key = row_name(f"{family}_seq", variant)
        print(f"kernels: {key} G={G} B={B} T={T} H={H} U={U.dtype}: "
              f"max_abs_err {err:.3e} (tol {TOL_FP32:g}); "
              f"{_seq_shape(family, B, H, U)}, {G * -(-B // 4)} clusters "
              f"a launch")
        check(err <= TOL_FP32, f"{key} H={H} disagrees with its plain "
                               f"version: {err:.3e}")
        ctx[key]["max_abs_err"] = max(ctx[key]["max_abs_err"], err)


def _seq_times(ctx, dev, family):
    """The sequence kernel timed at DeepBench's (1024, 25) slot (G=1, B=4,
    T=25, fp32 and bf16 U: U streamed from L2 each step), beside the
    plain version and cuDNN's nn.LSTM /
    nn.GRU (fp32, one layer, input GEMM included); and at the serving slot
    (G=2 B=4 T=8 H=340) in a CUDA graph of 20 launches, so that launch
    latency does not hide the kernel."""
    import torch

    gates, seq, plain = _seq_family(family)
    name = f"{family}_seq"
    times = ctx.setdefault(f"{name}_times", {})
    rnn = torch.nn.LSTM if family == "lstm" else torch.nn.GRU
    for ud in (torch.float32, torch.bfloat16):
        G, B, T, H = 1, 4, 25, 1024
        U, xw, h0, c0 = _seq_case(G, B, T, H, ud, torch.float32, seed=540,
                                  dev=dev, gates=gates)
        st = (h0, c0) if family == "lstm" else (h0,)
        k_ms = median_ms(lambda: seq(U, xw, *st), reps=5)
        p_ms = median_ms(lambda: plain(U, xw, *st), reps=2, trials=3)
        mod = rnn(H, H, batch_first=True).to(dev)
        x = torch.randn((B, T, H), device=dev)
        with torch.no_grad():
            l_ms = median_ms(lambda: mod(x), reps=5)
        b_ms, b_by = _seq_bound(family, G, B, T, H, U, None, None)
        times[f"G{G} B{B} T{T} H{H} {ud}"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
            bound_by=b_by)
        print(f"kernels: {name} at G={G} B={B} T={T} H={H} U={ud}: kernel "
              f"{k_ms:.4f} ms ({1e3 * k_ms / T:.2f} us a step), plain "
              f"{p_ms:.4f}, {rnn.__name__} (cuDNN, fp32, "
              f"input GEMM included) {l_ms:.4f}, bound {b_ms:.6f} ({b_by})")
        del U, xw, mod
    G, B, T, H = 2, 4, 8, 340
    ud = torch.float32 if family == "lstm" else torch.bfloat16
    U, xw, h0, c0 = _seq_case(G, B, T, H, ud, torch.float32, seed=541,
                              dev=dev, gates=gates)
    st = (h0, c0) if family == "lstm" else (h0,)
    g_ms = _graph_ms_each(lambda: seq(U, xw, *st))
    times[f"G{G} B{B} T{T} H{H} {ud}, graph of 20"] = dict(ms=g_ms)
    ctx[name]["graph_ms"] = g_ms
    print(f"kernels: {name} at G={G} B={B} T={T} H={H} U={ud} in a CUDA "
          f"graph of 20 launches: kernel {g_ms:.4f} ms a launch "
          f"({1e3 * g_ms / T:.2f} us a step)")


def _kernels_seq_variants(ctx, dev):
    """lstm_seq and gru_seq with int8 U, with row-compacted U and with
    both, against their plain versions on the same operands, then timed at
    a BYSDNE int8 wavefront slot (G=2 cells of layers 1 and 2, B=4, 15
    steps, H=340)."""
    import torch

    from repro_torch.kernels.common import ragged_b_mask
    from repro_torch.kernels.gru_cell import ops as gops
    from repro_torch.kernels.lstm_cell import ops as lops

    f32, bf16 = torch.float32, torch.bfloat16
    fams = {"lstm": (4, lops.lstm_seq, lops.lstm_seq_plain),
            "gru": (3, gops.gru_seq, gops.gru_seq_plain)}
    # wavefront slots at H=340 (ragged B, remainder chunks, bf16
    # activations) and H=50, whose last 8-row tile is 2 rows and whose 3H
    # takes the GRU kernel's scalar path
    cases = [(2, 4, 15, 340, f32, None, 1), (5, 4, 8, 340, f32,
                                             [4, 3, 4, 1, 1], 0),
             (3, 4, 8, 340, bf16, [4, 2, 1], 2), (2, 3, 9, 50, f32, [3, 1], 0)]
    for family, (gates, seq, plain) in fams.items():
        for variant in VARIANTS[1:]:
            err_max = 0.0
            for i, (G, B, T, H, ad, b_valid, l0) in enumerate(cases):
                U, xw, h0, c0 = _seq_case(G, B, T, H, f32, ad, seed=60 + i,
                                          dev=dev, gates=gates)
                U, sc, rows = _weight_branch(U, variant, first_layer=l0)
                mask = (None if b_valid is None
                        else ragged_b_mask(G, B, b_valid, dev))
                st = (h0, c0) if family == "lstm" else (h0,)
                ref = plain(U, xw, *st, mask, sc, rows)
                out = seq(U, xw, *st, b_valid=b_valid, u_scales=sc,
                          u_rows=rows)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                tol = TOL_FP32 if ad == f32 else TOL_BF16
                print(f"kernels: {family}_seq[{variant}] G={G} B={B} T={T} "
                      f"H={H} Hr={U.shape[1]} act={ad} b_valid={b_valid}: "
                      f"max_abs_err {err:.3e} (tol {tol:g}); "
                      f"{_seq_shape(family, B, H, U)}")
                check(err <= tol, f"{family}_seq[{variant}] disagrees with "
                                  f"its plain version: {err:.3e} > {tol:g}")
                if ad == f32:
                    err_max = max(err_max, err)
            # a remainder walk: chunks 8+8+8+5 chained through the state
            # against one plain walk over T=29
            U, xw, h0, c0 = _seq_case(2, 4, 29, 340, f32, f32, seed=70,
                                      dev=dev, gates=gates)
            U, sc, rows = _weight_branch(U, variant, first_layer=3)
            st = [h0, c0] if family == "lstm" else [h0]
            ref = plain(U, xw, *st, None, sc, rows)
            outs = []
            for t0 in range(0, 29, 8):
                o, *st = seq(U, xw[:, :, t0:t0 + 8], *st, u_scales=sc,
                             u_rows=rows, block_t=8)
                outs.append(o)
            err = max_err([torch.cat(outs, 2)] + st, ref)
            print(f"kernels: {family}_seq[{variant}] chunked 8+8+8+5 vs one "
                  f"plain walk T=29: max_abs_err {err:.3e} (tol "
                  f"{TOL_FP32:g})")
            check(err <= TOL_FP32, f"chunked {family}_seq[{variant}] walk "
                                   "disagrees")
            err_max = max(err_max, err)

            G, B, T, H = 2, 4, 15, 340
            U, xw, h0, c0 = _seq_case(G, B, T, H, f32, f32, seed=71,
                                      dev=dev, gates=gates)
            U, sc, rows = _weight_branch(U, variant, first_layer=1)
            st = (h0, c0) if family == "lstm" else (h0,)
            def call():
                return seq(U, xw, *st, u_scales=sc, u_rows=rows)

            k_ms = median_ms(call, reps=20)
            g_ms = _graph_ms_each(call)
            p_ms = median_ms(lambda: plain(U, xw, *st, None, sc, rows),
                             reps=20)
            b_ms, b_by = _seq_bound(family, G, B, T, H, U, sc, rows)
            key = row_name(f"{family}_seq", variant)
            ctx[key] = dict(max_abs_err=err_max, ms=k_ms, plain_ms=p_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by,
                            graph_ms=g_ms,
                            shape=f"G={G} B={B} T={T} H={H} Hr={U.shape[1]} "
                                  f"{U.dtype} U, fp32 xw/h")
            print(f"kernels: {key} at G={G} B={B} T={T} H={H} "
                  f"Hr={U.shape[1]} U={U.dtype}: kernel {k_ms:.4f} ms "
                  f"eager, {g_ms:.4f} ms a launch in a CUDA graph of 20 "
                  f"({1e3 * g_ms / T:.2f} us a step), plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
                  f"no library call takes this weight form")


def _rglru_case(B, T, W, seed, dev):
    """(log_a, gx, h0) of the scan: log_a = -|N|·0.3, gx and h0 N(0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    log_a = -torch.randn((B, T, W), generator=g).abs() * 0.3
    gx = torch.randn((B, T, W), generator=g)
    h0 = torch.randn((B, W), generator=g)
    return [t.to(dev) for t in (log_a, gx, h0)]


#: rglru_scan's bytes an element: log_a and gx read, hs written (fp32)
RGLRU_BYTES = 12
#: B = 1 (serve_lm's prefills) timed at these T, in a CUDA graph of
#: RGLRU_GRAPH_LAUNCHES launches
RGLRU_B1_T = (256, 1024, 2048)
RGLRU_GRAPH_LAUNCHES = 20


def _rglru_bound(B, T, W):
    """From the scan's Cost (``rglru_scan_cost``): 12 bytes an element and
    8 a channel, ``SCAN_OPS`` operations an element."""
    from repro_torch.kernels.rglru.ops import rglru_scan_cost

    return cost_bound(rglru_scan_cost(meta(B, T, W), meta(B, T, W),
                                      meta(B, W)))


def _rglru_same(a, b) -> bool:
    """Every tensor of ``a`` bit-equal to its twin in ``b``."""
    import torch

    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def _kernels_rglru(ctx, dev):
    """rglru_scan against its plain version at the rglru phase's shape, at
    ragged widths and at the edges of each strip width's tiles; bit for
    bit run to run, across B (a row of a B = 4 call against the B = 1 call
    on that row, which takes other strips) and between one call and the
    same T split over two calls (the second from the first's h_T); then
    timed at the rglru phase's shape (eager, as the phase runs it) and at
    B = 1 at serve_lm's prefill buckets (CUDA graphs of repeated
    launches)."""
    import torch

    from repro_torch.kernels.rglru import ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scan = ops.rglru_scan
    err_max = 0.0

    def held(args, label):
        nonlocal err_max
        ref = ops.rglru_scan_plain(*args)
        out = scan(*args)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        exact = bool(torch.equal(out[0][:, -1], out[1]))
        again = _rglru_same(scan(*args), out)
        B, T, W = args[0].shape
        C, steps = ops.scan_tile(B, W, sms)
        print(f"kernels: rglru_scan {label}B={B} T={T} W={W} (strips of "
              f"{C}, tiles of {steps} steps): max_abs_err {err:.3e} (tol "
              f"{TOL_FP32:g}); hs[:, -1] == h_T {exact}; bit-equal run to "
              f"run {again}")
        check(err <= TOL_FP32 and exact and again,
              f"rglru_scan disagrees with its plain version or itself at "
              f"B={B} T={T} W={W}: {err:.3e}")
        err_max = max(err_max, err)

    cases = {}
    for i, (B, T, W) in enumerate(((4, 2048, 2560), (1, 64, 513),
                                   (3, 13, 100), (2, 1, 33))):
        cases[(B, T, W)] = args = _rglru_case(B, T, W, seed=80 + i, dev=dev)
        held(args, "")
    # the tiles' edges: T = 1 and a tile's steps -1, 0, +1 for each strip
    # width (B picks it at W = 2560), and the ragged widths
    edges = []
    for B in (4, 2, 1):
        _, steps = ops.scan_tile(B, 2560, sms)
        edges += [(B, T, 2560) for T in (1, steps - 1, steps, steps + 1)]
    _, steps = ops.scan_tile(1, 513, sms)
    edges += [(B, T, W) for B in (1, 4) for W in (33, 513)
              for T in (1, steps - 1, steps + 1)]
    for i, (B, T, W) in enumerate(edges):
        held(_rglru_case(B, T, W, seed=100 + i, dev=dev), "edge ")

    # across B: each row of the B = 4 call against the B = 1 call on it
    la, gx, h0 = cases[(4, 2048, 2560)]
    full = scan(la, gx, h0)
    rows = all(_rglru_same(scan(la[b:b + 1], gx[b:b + 1], h0[b:b + 1]),
                           (full[0][b:b + 1], full[1][b:b + 1]))
               for b in range(4))
    # one call against the same T split over two calls
    split = []
    for (B, T, W), cut in (((4, 2048, 2560), 1000), ((1, 64, 513), 37)):
        la, gx, h0 = cases[(B, T, W)]
        whole = scan(la, gx, h0)
        hs1, h1 = scan(la[:, :cut].contiguous(), gx[:, :cut].contiguous(), h0)
        hs2, h2 = scan(la[:, cut:].contiguous(), gx[:, cut:].contiguous(), h1)
        split.append(_rglru_same((torch.cat([hs1, hs2], 1), h2), whole))
    torch.cuda.synchronize()
    print(f"kernels: rglru_scan bit for bit: rows of B=4 T=2048 W=2560 == "
          f"the B=1 calls {rows}; one call == two calls split at T=1000 "
          f"(B=4 T=2048 W=2560) {split[0]}, at T=37 (B=1 T=64 W=513) "
          f"{split[1]}")
    check(rows and all(split), "rglru_scan is not bit-equal across B or "
                               "across a split of T")

    B, T, W = 4, 2048, 2560
    args = _rglru_case(B, T, W, seed=90, dev=dev)
    k_ms = median_ms(lambda: scan(*args), reps=20)
    p_ms = median_ms(lambda: ops.rglru_scan_plain(*args), reps=1, trials=3)
    b_ms, b_by = _rglru_bound(B, T, W)
    nbytes = RGLRU_BYTES * B * T * W
    print(f"kernels: rglru_scan at B={B} T={T} W={W} (eager): kernel "
          f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s, "
          f"{k_ms / b_ms:.2f}x the bound), plain {p_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); no single PyTorch call computes a gated "
          f"linear recurrence")
    ctx["rglru_scan"] = dict(max_abs_err=err_max, ms=k_ms, plain_ms=p_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             shape=f"B={B} T={T} W={W} fp32")
    n = RGLRU_GRAPH_LAUNCHES
    for T in RGLRU_B1_T:
        args = _rglru_case(1, T, W, seed=91, dev=dev)
        ms = graph_ms(lambda: [scan(*args) for _ in range(n)]) / n
        b_ms, b_by = _rglru_bound(1, T, W)
        print(f"kernels: rglru_scan at B=1 T={T} W={W} (one CUDA graph of "
              f"{n} launches): kernel {ms:.4f} ms a launch "
              f"({RGLRU_BYTES * T * W / ms / 1e6:.1f} GB/s, "
              f"{ms / b_ms:.2f}x the bound), bound {b_ms:.6f} ms ({b_by})")
        if T == 2048:
            ctx["rglru_scan"].update(b1_ms=ms, b1_bound_ms=b_ms)


#: the decode step's projections of RecurrentGemma-2B (X, N): the MLP's
#: w_gate / w_up, its w_down, the RG-LRU block's w_in / w_gate / w_out and
#: the attention block's w_q / w_o, and its w_kv
MVM_SHAPES = ((2560, 7680), (7680, 2560), (2560, 2560), (2560, 512))
#: ragged shapes that reach the cluster split's edges: X = 5 < S (CTAs
#: with empty X-slices), X = 2561 (a ragged last slice), N = 129 (the
#: scalar-load instance and a ragged stripe), N = 520 (a ragged stripe)
MVM_EDGES = ((5, 129), (2561, 520), (2561, 129), (5, 520))


def _mvm_step_mix(n_layers, kinds):
    """The (X, N) of the decode step's projections, in its order: per
    rglru layer w_gate, w_in, w_out (2560 x 2560), per attn layer w_q
    (2560 x 2560), w_kv (2560 x 512), w_o (2560 x 2560), then every
    layer's MLP w_gate, w_up (2560 x 7680) and w_down (7680 x 2560)."""
    d, ff, kv = 2560, 7680, 512
    mix = []
    for kind in kinds[:n_layers]:
        mix += [(d, d), (d, kv), (d, d)] if kind == "attn" else [(d, d)] * 3
        mix += [(d, ff), (d, ff), (ff, d)]
    return mix


def _kernels_mvm(ctx, dev):
    """mvm against its plain version at the decode step's projections (B =
    1..4) and at ragged shapes that reach the cluster split's edges (fp32
    and bf16, with and without bias); two runs bit-equal and a row of a B
    = 4 call bit-equal to the same row at B = 1; then timed warm at each
    projection (B = 4 and 1) and cold over the decode step's 156
    projections on distinct weights."""
    import torch

    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.kernels.mvm_tile import ops

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator().manual_seed(100)
    err_max = 0.0
    cases = [(B, X, N, bf16, False) for X, N in MVM_SHAPES
             for B in (1, 2, 3, 4)]
    cases += [(3, X, N, dt, with_b) for X, N in MVM_EDGES
              for dt in (f32, bf16) for with_b in (False, True)]
    cases += [(1, 2560, 7680, bf16, True)]
    inputs = {}
    for B, X, N, dt, with_b in cases:
        x = torch.randn((B, X), generator=g).to(dev, dt)
        W = (torch.randn((X, N), generator=g) * X ** -0.5).to(dev, dt)
        b = torch.randn((N,), generator=g).to(dev) if with_b else None
        ref = ops.mvm_plain(x, W, b)
        out = ops.mvm(x, W, b)
        again = ops.mvm(x, W, b)
        row0 = ops.mvm(x[:1].contiguous(), W, b)
        torch.cuda.synchronize()
        err = max_err((out,), (ref,))
        tol = (TOL_FP32 if dt == f32
               else ULP_BF16 * float(ref.float().abs().max()))
        same = bool(torch.equal(out, again))
        batch = bool(torch.equal(out[:1], row0))
        print(f"kernels: mvm B={B} X={X} N={N} {dt} bias={with_b} "
              f"(S={ops.splits(X, N)}): max_abs_err {err:.3e} (tol "
              f"{tol:g}); two runs bit-equal {same}; row 0 == its B=1 call "
              f"{batch}")
        check(err <= tol and out.dtype == dt,
              f"mvm disagrees with its plain version: {err:.3e} > {tol:g}")
        check(same and batch, f"mvm B={B} X={X} N={N}: not bit-equal run "
                              "to run, or a row differs from its B=1 call")
        err_max = max(err_max, err)
        if not with_b and (X, N) in MVM_SHAPES and B in (1, 4):
            inputs[(B, X, N)] = (x, W)

    for X, N in MVM_SHAPES:
        S = ops.splits(X, N)
        ctas = -(-N // ops.STRIPE) * S
        n_cl = [ops.max_clusters(B, X, N) for B in (1, 4)]
        print(f"kernels: mvm X={X} N={N}: clusters of S={S} CTAs, {ctas} "
              f"CTAs a launch per 4 rows; cudaOccupancyMaxActiveClusters "
              f"{n_cl[0]} (B=1), {n_cl[1]} (B=4): one wave "
              f"{n_cl[1] * S >= ctas}")
        check(min(n_cl) > 0, f"mvm: a cluster of {S} CTAs does not fit")

    # warm: 5 x 50 back-to-back launches on one W.  A 2560 x 7680 bf16 W
    # (39.3 MB) fits in the 50 MB L2, so these launches reread W from L2
    # and can beat the HBM bound; the step mix below cannot.
    for B in (4, 1):
        for X, N in MVM_SHAPES:
            x, W = inputs[(B, X, N)]
            k_ms = median_ms(lambda: ops.mvm(x, W), reps=50)
            p_ms = median_ms(lambda: ops.mvm_plain(x, W), reps=50)
            l_ms = median_ms(lambda: torch.matmul(x, W), reps=50)
            c = ops.mvm_cost(x, W)
            nbytes = c.bytes
            b_ms, b_by = cost_bound(c, "bf16")
            print(f"kernels: mvm warm (W from L2) at B={B} X={X} N={N} "
                  f"bf16: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} "
                  f"GB/s), plain {p_ms:.4f} ms, torch.matmul (cuBLAS) "
                  f"{l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
            ctx.setdefault("mvm_shapes", {})[f"B{B} {X}x{N}"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by)

    # cold: the decode step's 156 projections in its order, each on its own
    # weight (4.0 GB of bf16, so nothing is reread from L2), captured in a
    # CUDA graph as the decode step runs them, and timed with CUDA events
    # around the whole sequence's replay
    cfg = recurrentgemma_2b.config()
    mix = _mvm_step_mix(cfg.n_layers, cfg.layer_kinds())
    gen = torch.Generator(device=dev).manual_seed(101)
    Ws = [torch.randn((X, N), generator=gen, device=dev, dtype=bf16)
          for X, N in mix]
    for B in (1, 4):
        xs = {X: torch.randn((B, X), generator=gen, device=dev, dtype=bf16)
              for X in {X for X, _ in mix}}
        k_ms = graph_ms(lambda: [ops.mvm(xs[W.shape[0]], W) for W in Ws])
        l_ms = graph_ms(lambda: [torch.matmul(xs[W.shape[0]], W)
                                 for W in Ws])
        costs = [ops.mvm_cost(xs[W.shape[0]], W) for W in Ws]
        nbytes = sum(c.bytes for c in costs)
        b_ms, b_by = bound(nbytes, sum(c.ops for c in costs), "bf16")
        print(f"kernels: mvm step mix ({len(mix)} projections on distinct "
              f"weights, {nbytes / 1e9:.3f} GB) at B={B}: kernel {k_ms:.4f} "
              f"ms ({nbytes / k_ms / 1e6:.1f} GB/s), torch.matmul (cuBLAS) "
              f"{l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); kernel / "
              f"bound {k_ms / b_ms:.2f}, kernel / matmul {k_ms / l_ms:.2f}")
        ctx.setdefault("mvm_step_mix", {})[f"B{B}"] = dict(
            ms=k_ms, library_ms=l_ms, bound_ms=b_ms, gb=nbytes / 1e9)
        # the mix by shape: each shape's distinct weights in one graph, per
        # launch, kernel beside torch.matmul (and, for the summary's row,
        # the plain version) under the same condition
        for X, N in MVM_SHAPES:
            sub = [W for W in Ws if tuple(W.shape) == (X, N)]
            x = xs[X]
            k_ms = graph_ms(lambda: [ops.mvm(x, W) for W in sub]) / len(sub)
            l_ms = graph_ms(lambda: [torch.matmul(x, W)
                                     for W in sub]) / len(sub)
            cold = dict(ms=k_ms, library_ms=l_ms)
            if B == 4 and (X, N) == MVM_SHAPES[0]:
                cold["plain_ms"] = graph_ms(
                    lambda: [ops.mvm_plain(x, W) for W in sub]) / len(sub)
            print(f"kernels: mvm step mix by shape at B={B} X={X} N={N} "
                  f"({len(sub)} distinct weights, one graph, S="
                  f"{ops.splits(X, N)}), ms a launch: kernel {k_ms:.4f}, "
                  f"torch.matmul (cuBLAS) {l_ms:.4f}"
                  + (f", plain {cold['plain_ms']:.4f}"
                     if "plain_ms" in cold else ""))
            ctx.setdefault("mvm_cold", {})[f"B{B} {X}x{N}"] = cold
    # the summary's row: the widest projection at B = 4 as the decode step
    # runs it, cold in a graph, the kernel, its plain version and
    # torch.matmul alike; the warm eager time (PR 14's row) beside it
    X, N = MVM_SHAPES[0]
    warm = ctx["mvm_shapes"][f"B4 {X}x{N}"]
    cold = ctx["mvm_cold"][f"B4 {X}x{N}"]
    ctx["mvm"] = dict(max_abs_err=err_max, ms=cold["ms"],
                      plain_ms=cold["plain_ms"], library_ms=cold["library_ms"],
                      bound_ms=warm["bound_ms"], bound_by=warm["bound_by"],
                      warm_ms=warm["ms"],
                      condition=f"B=4 X={X} N={N} bf16; ms, plain_ms and "
                                "library_ms cold in a CUDA graph, warm_ms "
                                "warm and eager")
    del Ws
    torch.cuda.empty_cache()


def _attn_case(B, T, Hq, Hk, D, dt, valid, seed, dev):
    """(q, k_cache, v_cache, valid) of the decode attention kernel."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g).to(dev, dt)
    k = torch.randn((B, T, Hk, D), generator=g).to(dev, dt)
    v = torch.randn((B, T, Hk, D), generator=g).to(dev, dt)
    return q, k, v, torch.tensor(valid, dtype=torch.int32, device=dev)


def _attn_share(out, ref) -> float:
    """The worst |kernel - plain| over its limit (<= 1 passes): fp32
    within TOL_FP32; bf16 per (row, query head), one bf16 ulp of that
    head's largest output (ULP_BF16)."""
    import torch

    diff = (out.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        return float(diff.max()) / TOL_FP32
    limit = ULP_BF16 * ref.float().abs().amax(-1)
    return float((diff.amax(-1) / limit).max())


#: the RecurrentGemma-2B attention layers' decode shape (B, T, Hq, Hk, D)
ATTN_SHAPE = (4, 2048, 10, 1, 256)
#: decode_attention's timed rings: a full ring, the kernels phase's mixed
#: valid, and rings like serve_lm's (~70 live slots for most steps), at
#: B = 4 and B = 1
ATTN_RINGS = {4: {"full": [2048] * 4, "mixed": [1, 700, 1537, 2048],
                  "serve": [65, 70, 72, 75]},
              1: {"full": [2048], "mixed": [1537], "serve": [70]}}
#: distinct ring pairs in one timed graph: at least the decode step's 8
#: attention layers, and together more than the 50 MB L2 (x 1.25), so
#: every launch reads its rings from HBM
L2_BYTES = 50e6


def _kernels_decode_attention(ctx, dev):
    """decode_attention against its plain version at the attention layers'
    decode (mixed valid, a full ring, the edge valid counts of the kernel's
    tiles at B = 4 and B = 1), an fp32 GQA shape and a head dim that
    takes the scalar loads; bit-equal run to run, across B and between a
    graph replay and the eager call; its clusters' occupancy; then timed
    cold in CUDA graphs (ATTN_RINGS; the kernel, its plain version and
    F.scaled_dot_product_attention alike, each launch on its own rings)
    and warm and eager on a full ring, as PRs 14 and 16 timed it."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, T, Hq, Hk, D = ATTN_SHAPE
    G = Hq // Hk
    mixed = ATTN_RINGS[4]["mixed"]
    # the edge valid counts of the kernel's tiles: 0 (every slot masked),
    # 1, 2, the first tile boundary, the end of the cluster's first round
    # of tiles (R slots), each +- 1, T - 1, T and past T
    tile, R = ops.TILE, ops.splits(T) * ops.TILE
    edges = [0, 1, 2, tile - 1, tile, tile + 1, R - 1, R, R + 1, T - 1, T,
             T + 5]
    err_max = 0.0
    cases = [
        (_attn_case(B, T, Hq, Hk, D, bf16, mixed, 110, dev),
         f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid={mixed}"),
        (_attn_case(B, T, Hq, Hk, D, bf16, [T] * B, 111, dev),
         f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid=T"),
        (_attn_case(2, 256, 8, 2, 64, f32, [3, 256], 112, dev),
         "B=2 T=256 Hq=8 Hk=2 D=64 fp32 valid=[3, 256]"),
        # D = 20: the scalar-load instance (not a multiple of 8 bf16)
        (_attn_case(2, 128, 6, 3, 20, bf16, [50, 128], 114, dev),
         "B=2 T=128 Hq=6 Hk=3 D=20 bf16 valid=[50, 128]")]
    # three calls of four rows and one call per row
    q, k, v, vl = _attn_case(len(edges), T, Hq, Hk, D, bf16, edges, 115, dev)
    for lo in range(0, len(edges), B):
        rows = slice(lo, lo + B)
        cases.append(((q[rows], k[rows], v[rows], vl[rows]),
                      f"B={B} T={T} bf16 valid={edges[rows]}"))
    for r in range(len(edges)):
        cases.append(((q[r:r + 1], k[r:r + 1], v[r:r + 1], vl[r:r + 1]),
                      f"B=1 T={T} bf16 valid={edges[r]}"))
    for args, label in cases:
        bt = ops.default_block_t(args[1].shape[1])
        ref = ops.decode_attention_plain(*args, block_t=bt)
        out = ops.decode_attention(*args)
        again = ops.decode_attention(*args)
        torch.cuda.synchronize()
        share = _attn_share(out, ref)
        same = bool(torch.equal(out, again))
        print(f"kernels: decode_attention {label} (S="
              f"{ops.splits(args[1].shape[1])}): max_abs_err "
              f"{max_err((out,), (ref,)):.3e} (worst head at {share:.3f} of "
              f"its limit); two runs bit-equal {same}")
        check(share <= 1.0, f"decode_attention disagrees with its plain "
                            f"version ({label}): {share:.3f} of the limit")
        check(same, f"decode_attention {label}: two runs differ")
        err_max = max(err_max, max_err((out,), (ref,)))
    # a row is bit-equal at B = 4 and B = 1, and a graph replay is the eager
    # call
    rows4 = ops.decode_attention(q[:B], k[:B], v[:B], vl[:B])
    alone = [ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                  vl[r:r + 1]) for r in range(B)]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        replayed = ops.decode_attention(q[:B], k[:B], v[:B], vl[:B])
    graph.replay()
    torch.cuda.synchronize()
    batch = all(torch.equal(rows4[r], alone[r][0]) for r in range(B))
    replay = bool(torch.equal(replayed, rows4))
    del graph
    print(f"kernels: decode_attention rows of a B={B} call == their B=1 "
          f"calls {batch}; a CUDA graph's replay == the eager call {replay}")
    check(batch and replay, "decode_attention: a row differs between B=4 "
                            "and B=1, or a replay from the eager call")
    n_cl = [ops.max_clusters(b, T, Hk, G, D) for b in (1, B)]
    print(f"kernels: decode_attention T={T}: clusters of S={ops.splits(T)} "
          f"CTAs ({ops.splits(T) * Hk} CTAs a row); "
          f"cudaOccupancyMaxActiveClusters {n_cl[0]} (B=1), {n_cl[1]} "
          f"(B={B}): one wave {n_cl[1] >= B * Hk}")
    check(min(n_cl) > 0, "decode_attention: a cluster does not fit")

    # cold: each ring case as a CUDA graph of n launches on n distinct ring
    # pairs (n >= 8, the decode step's attention layers, and more than L2
    # holds), per launch; the kernel, the plain version and SDPA alike
    gen = torch.Generator(device=dev).manual_seed(116)
    for b, rings in ATTN_RINGS.items():
        ring_bytes = 2 * b * T * Hk * D * 2
        n = max(8, math.ceil(1.25 * L2_BYTES / ring_bytes))
        sets = [[torch.randn(shape, generator=gen, device=dev, dtype=bf16)
                 for shape in ((b, Hq, D), (b, T, Hk, D), (b, T, Hk, D))]
                for _ in range(n)]
        # SDPA's layout (B, H, T, D), made outside the timed graph
        sdpa = [(qq[:, :, None], kk.transpose(1, 2).contiguous(),
                 vv.transpose(1, 2).contiguous()) for qq, kk, vv in sets]
        for name, valid in rings.items():
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            mask = (torch.arange(T, device=dev)[None, :] < vl[:, None])[
                :, None, None, :]
            k_ms = graph_ms(lambda: [ops.decode_attention(qq, kk, vv, vl)
                                     for qq, kk, vv in sets]) / n
            p_ms = graph_ms(lambda: [ops.decode_attention_plain(
                qq, kk, vv, vl, block_t=ops.default_block_t(T))
                for qq, kk, vv in sets], trials=3) / n
            l_ms = graph_ms(lambda: [F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
                for qs, ks, vs in sdpa]) / n
            # this run's data: the live slots' keys and values are read
            # once, and each needs 4 Hq D operations (q.k and p.v)
            live = sum(min(x, T) if x >= 1 else T for x in valid)
            nbytes = 2 * (2 * live * Hk * D + 2 * b * Hq * D) + 4 * b
            b_ms, b_by = bound(nbytes, 4 * live * Hq * D, "bf16")
            print(f"kernels: decode_attention cold in a graph at B={b} "
                  f"T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid={valid} ({n} "
                  f"distinct ring pairs, {n * ring_bytes / 1e6:.1f} MB), ms "
                  f"a launch: kernel {k_ms:.4f} ({nbytes / k_ms / 1e6:.1f} "
                  f"GB/s), plain {p_ms:.4f}, F.scaled_dot_product_attention "
                  f"(mask, GQA) {l_ms:.4f}, bound {b_ms:.6f} ({b_by}); "
                  f"kernel / SDPA {k_ms / l_ms:.2f}, kernel / bound "
                  f"{k_ms / b_ms:.2f}; the decode step's 8 launches "
                  f"{8 * k_ms:.4f} ms")
            ctx.setdefault("decode_attention_cold", {})[f"B{b} {name}"] = \
                dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                     bound_by=b_by, valid=valid, rings=n)
        del sets, sdpa
    # warm and eager on one full ring (PR 14 and 16's condition: host
    # launch costs inside, rings from L2)
    q, k, v, vl = _attn_case(B, T, Hq, Hk, D, bf16, [T] * B, 113, dev)
    w_ms = median_ms(lambda: ops.decode_attention(q, k, v, vl), reps=50)
    qs, ks, vs = (q[:, :, None], k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())
    mask = (torch.arange(T, device=dev)[None, :] < vl[:, None])[
        :, None, None, :]
    wl_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), reps=50)
    print(f"kernels: decode_attention warm and eager at B={B} T={T} bf16 "
          f"valid=T (one ring, from L2): kernel {w_ms:.4f} ms, "
          f"F.scaled_dot_product_attention {wl_ms:.4f} ms")
    cold = ctx["decode_attention_cold"][f"B{B} full"]
    ml = _attn_stats(dev)
    ctx["decode_attention"] = dict(
        **ml, max_abs_err=err_max, ms=cold["ms"],
        plain_ms=cold["plain_ms"], library_ms=cold["library_ms"],
        bound_ms=cold["bound_ms"], bound_by=cold["bound_by"], warm_ms=w_ms,
        condition=f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16, full ring; ms, "
                  "plain_ms and library_ms cold in a CUDA graph (distinct "
                  "rings, from HBM), warm_ms warm and eager")


#: decode_attention's (m, l) form (return_stats: o in fp32 and each head's
#: softmax statistics) against its plain version: the same fp32 sums in
#: other orders (a few fp32 ulps of the largest output, max score and exp
#: sum), relative to each head's largest |o|, |m| (at least 1) and l
TOL_STATS = 1e-5


def _attn_stats(dev):
    """decode_attention's (m, l) form against its plain version: at the
    RecurrentGemma shape with a row of no live slot (the combine's
    identity, (0, -inf, 0), exactly), an fp32 GQA shape, and the two
    halves of a starcoder2-3b ring as the mesh phase's ranks take them;
    then timed beside the plain form cold in a CUDA graph on distinct
    full rings (B = 4, ATTN_SHAPE).  Returns the summary row's ml_ keys."""
    import math

    import torch

    from repro_torch.kernels.decode_attention import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, T, Hq, Hk, D = ATTN_SHAPE
    cases = [
        (_attn_case(B, T, Hq, Hk, D, bf16, [0, 700, 1537, 2048], 120, dev),
         f"B={B} T={T} Hq={Hq} Hk={Hk} D={D} bf16 valid=[0, 700, 1537, "
         "2048]"),
        (_attn_case(2, 256, 8, 2, 64, f32, [3, 256], 121, dev),
         "B=2 T=256 Hq=8 Hk=2 D=64 fp32 valid=[3, 256]")]
    q, k, v, _ = _attn_case(4, 512, 24, 2, 128, bf16, [512] * 4, 122, dev)
    for lo, valid in ((0, [24, 100, 256, 256]), (256, [0, 0, 0, 44])):
        cases.append(((q, k[:, lo:lo + 256].contiguous(),
                       v[:, lo:lo + 256].contiguous(),
                       torch.tensor(valid, dtype=torch.int32, device=dev)),
                      f"starcoder2-3b half ring B=4 T=256 Hq=24 Hk=2 D=128 "
                      f"bf16 valid={valid}"))
    worst = 0.0
    for args, label in cases:
        o, m, l = ops.decode_attention(*args, return_stats=True)
        ro, rm, rl = ops.decode_attention_plain(
            *args, block_t=ops.default_block_t(args[1].shape[1]),
            return_stats=True)
        torch.cuda.synchronize()
        live = args[3] >= 1
        share = max(
            float(((o - ro).abs().amax(-1)[live] / ro.abs().amax(-1)[live]
                   .clamp_min(1e-30)).max()),
            float(((m - rm).abs()[live] / rm.abs()[live].clamp_min(1.0))
                  .max()),
            float(((l - rl).abs()[live] / rl[live]).max())) / TOL_STATS
        empty = ~live
        ident = bool((o[empty] == 0).all() and (m[empty] == -math.inf).all()
                     and (l[empty] == 0).all())
        print(f"kernels: decode_attention (m, l) form {label}: o, m, l at "
              f"{share:.3f} of TOL_STATS {TOL_STATS:g} (relative); rows of "
              f"no live slot the identity (0, -inf, 0) {ident}; o {o.dtype}")
        check(share <= 1.0, f"decode_attention (m, l) form disagrees with "
                            f"its plain version ({label}): {share:.3f}")
        check(ident, f"decode_attention (m, l) form {label}: an empty row "
                     "is not (0, -inf, 0)")
        check(o.dtype == f32, "decode_attention (m, l) form: o not fp32")
        worst = max(worst, share * TOL_STATS)
    # cold, as the plain form's rows are timed: distinct full rings
    ring_bytes = 2 * B * T * Hk * D * 2
    n = max(8, math.ceil(1.25 * L2_BYTES / ring_bytes))
    gen = torch.Generator(device=dev).manual_seed(123)
    sets = [[torch.randn(shape, generator=gen, device=dev, dtype=bf16)
             for shape in ((B, Hq, D), (B, T, Hk, D), (B, T, Hk, D))]
            for _ in range(n)]
    vl = torch.full((B,), T, dtype=torch.int32, device=dev)
    base = graph_ms(lambda: [ops.decode_attention(qq, kk, vv, vl)
                             for qq, kk, vv in sets]) / n
    ml_ms = graph_ms(lambda: [ops.decode_attention(qq, kk, vv, vl,
                                                   return_stats=True)
                              for qq, kk, vv in sets]) / n
    plain = graph_ms(lambda: [ops.decode_attention_plain(
        qq, kk, vv, vl, block_t=ops.default_block_t(T), return_stats=True)
        for qq, kk, vv in sets], trials=3) / n
    # (m, l) form: o in fp32 and 8 bytes a head more than the plain form
    nbytes = 2 * (2 * B * T * Hk * D + B * Hq * D) + 4 * B * Hq * D \
        + 8 * B * Hq + 4 * B
    b_ms, b_by = bound(nbytes, 4 * B * T * Hq * D, "bf16")
    print(f"kernels: decode_attention (m, l) form cold in a graph at B={B} "
          f"T={T} Hq={Hq} Hk={Hk} D={D} bf16, full rings ({n} distinct): "
          f"{ml_ms:.4f} ms a launch against {base:.4f} for the output alone "
          f"in the same call ({ml_ms / base:.3f}x); plain (m, l) form "
          f"{plain:.4f}; bound {b_ms:.6f} ({b_by})")
    del sets
    return dict(ml_ms=ml_ms, ml_base_ms=base, ml_plain_ms=plain,
                ml_bound_ms=b_ms, ml_max_rel_err=worst)


#: the reference's six dense decoders at full width, as serve_dense runs
#: them: (arch, layers run or None for all, why the depth is cut)
DENSE_RUNS = (
    ("stablelm-12b", None, ""),
    ("starcoder2-3b", None, ""),
    ("h2o-danube-3-4b", None, ""),
    ("deepseek-67b", 24, "95 layers are 135 GB of bf16 weights, more than "
                         "one 80 GB card; 24 layers (36.6 GB) is a depth "
                         "chosen to keep the phase short, not the most "
                         "the card holds (its peak memory is printed)"),
    ("musicgen-large", None, ""),
    ("qwen2-vl-72b", 16, "80 layers are 145 GB of bf16 weights, more than "
                         "one 80 GB card; 16 layers (30.6 GB) is a depth "
                         "chosen to keep the phase short, not the most "
                         "the card holds (its peak memory is printed)"),
)
#: serve_moe: the MoE decoders at full width, one on the card at a time
MOE_RUNS = (
    ("olmoe-1b-7b", None, ""),
    ("arctic-480b", 2, "35 layers are 952 GB of bf16 weights (27.2 GB a "
                       "layer: 128 experts of 3 x 7168 x 4864, its dense "
                       "branch, attention), twelve 80 GB cards; 2 layers "
                       "(55.3 GB with the embeddings) are the most one card "
                       "holds beside the serving buffers"),
)
#: serve_xlstm: xlstm-125m whole
XLSTM_RUN = ("xlstm-125m", None, "")
#: every arch the kernels phase takes decode shapes from (_kernels_dense)
DECODER_RUNS = DENSE_RUNS + MOE_RUNS + (XLSTM_RUN,)
#: decode_attention's decoder shapes are held and timed at this ring length
#: (h2o-danube's 4096-slot window; a 4096-position context of the others),
#: and held at the rings serve_dense and serve_moe decode on
#: (_dense_served)
DENSE_ATTN_T = 4096


def _dense_max_seq(cfg):
    """serve_dense's ServingEngine max_seq for a token arch: room for
    DENSE_LONG with a window, else DENSE_MAX_SEQ."""
    return DENSE_LONG_MAX_SEQ if cfg.window else DENSE_MAX_SEQ


def _dense_served(cfg):
    """The (B, T) of every decode step serve_dense runs for ``cfg``: the
    engine's ticks and batch-1 steps on its rings, or the embeds archs'
    DENSE_EMBEDS rows on their prefill's rings."""
    from repro_torch.models import transformer as tf

    if cfg.embed_stub:
        B, S, N = DENSE_EMBEDS
        return [(B, tf.cache_len(cfg, S + N))]
    T = tf.cache_len(cfg, _dense_max_seq(cfg))
    return [(4, T), (1, T)]


def _dense_config(arch, layers=None):
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _step_mvm_shapes(cfg):
    """The (X, N) of every mvm launch of one decode step of ``cfg``, in
    its order (``models.layers.common.project``): an attention layer's
    w_q, w_kv, w_o; an RG-LRU layer's w_gate, w_in, w_out; an mLSTM
    layer's w_up_v, w_up_g, w_q, w_k, w_v, w_down; an sLSTM layer's W,
    w_out; then an attention or RG-LRU layer's MLP (w_gate, w_up, w_down),
    or with MoE the dense branch's (arctic) and nothing else: the router
    and the experts are no projection."""
    d, out = cfg.d_model, []
    for kind in cfg.layer_kinds():
        if kind == "attn":
            out += [(d, cfg.q_dim), (d, 2 * cfg.kv_dim), (cfg.q_dim, d)]
        elif kind == "rglru":
            w = cfg.rglru_width
            out += [(d, w), (d, w), (w, d)]
        elif kind == "mlstm":
            out += [(d, 2 * d), (d, 2 * d)] + [(2 * d, 2 * d)] * 3 + [
                (2 * d, d)]
        else:
            out += [(d, 4 * d), (d, d)]
        ff = cfg.moe_dense_ff if cfg.n_experts else cfg.d_ff
        if kind in ("attn", "rglru") and ff:
            out += [(d, ff), (d, ff), (ff, d)]
    return out


def _attn_branch(D):
    """The instance of csrc/decode_attention.cu that bf16 q and rings of
    head dim D take (its by_vec / by_heads dispatch)."""
    if D % 16 == 0:
        return "tensor cores (MMA)"
    return ("CUDA cores, by_heads, 16-byte loads" if D % 8 == 0
            else "CUDA cores, by_heads, scalar loads")


def _kernels_dense(ctx, dev):
    """mvm and decode_attention at the decoders' full-width shapes
    (serve_dense's, serve_moe's and serve_xlstm's archs, DECODER_RUNS):
    mvm at every (X, N) of their decode steps (bf16,
    B = 4 and 2) against its plain version, bit-equal run to run and the
    rows of B = 4 equal to their B = 1 and B = 2 calls, then timed cold
    in a CUDA graph on distinct weights beside torch.matmul (B = 4 and
    1); decode_attention at every (Hk, G, D) on DENSE_ATTN_T-slot rings
    (bf16, B = 4 mixed valid and a full ring, B = 1) and at every (B, T)
    serve_dense decodes it on (_dense_served: a full ring and the edge
    valid counts of the kernel's tiles) against its plain version under
    the per-head bf16 limit, bit-equal run to run, then timed cold at
    DENSE_ATTN_T in CUDA graphs on distinct rings (more than L2 holds at
    each B) beside its plain version and F.scaled_dot_product_attention.
    Each arch's mvm step (_step_mvm_shapes) is summed from the per-shape
    times."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.mvm_tile import ops as mops

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(120)
    gen = torch.Generator(device=dev).manual_seed(121)
    shapes = {}
    for arch, layers, _ in DECODER_RUNS:
        cfg = _dense_config(arch, layers)
        for X, N in _step_mvm_shapes(cfg):
            archs = shapes.setdefault((X, N), [])
            if arch not in archs:
                archs.append(arch)
    mvm_rec, mvm_err = {}, 0.0
    for (X, N), archs in shapes.items():
        x = torch.randn((4, X), generator=g).to(dev, bf16)
        W = (torch.randn((X, N), generator=gen, device=dev)
             * X ** -0.5).to(bf16)
        ref = mops.mvm_plain(x, W)
        out, again = mops.mvm(x, W), mops.mvm(x, W)
        row0 = mops.mvm(x[:1].contiguous(), W)
        # B = 2: the embeds archs' decode steps
        x2 = x[:2].contiguous()
        ref2 = mops.mvm_plain(x2, W)
        two, two_again = mops.mvm(x2, W), mops.mvm(x2, W)
        torch.cuda.synchronize()
        err = max(max_err((out,), (ref,)), max_err((two,), (ref2,)))
        tol = ULP_BF16 * float(ref.float().abs().max())
        same = bool(torch.equal(out, again) and torch.equal(two, two_again))
        batch = bool(torch.equal(out[:1], row0) and torch.equal(out[:2], two))
        check(err <= tol, f"mvm X={X} N={N} disagrees with its plain "
                          f"version at B=4 or B=2: {err:.3e} > {tol:g}")
        check(same and batch, f"mvm X={X} N={N}: not bit-equal run to run, "
                              "or rows differ from their B=1 / B=2 calls")
        mvm_err = max(mvm_err, err)
        # cold: distinct weights, together more than L2 holds
        n = max(2, math.ceil(1.25 * L2_BYTES / (2 * X * N)))
        Ws = [torch.randn((X, N), generator=gen, device=dev, dtype=bf16)
              for _ in range(n)]
        rec = {"archs": archs, "max_abs_err": err, "S": mops.splits(X, N)}
        for B in (4, 1):
            xb = x[:B].contiguous()
            k_ms = graph_ms(lambda: [mops.mvm(xb, w) for w in Ws]) / n
            l_ms = graph_ms(lambda: [torch.matmul(xb, w) for w in Ws]) / n
            b_ms, b_by = cost_bound(mops.mvm_cost(xb, Ws[0]), "bf16")
            rec[f"B{B}"] = dict(ms=k_ms, library_ms=l_ms, bound_ms=b_ms,
                                bound_by=b_by)
        del Ws
        print(f"kernels: mvm X={X} N={N} bf16 ({', '.join(archs)}; "
              f"S={rec['S']}): max_abs_err {err:.3e} over B=4 and B=2 (tol "
              f"{tol:g}); two runs bit-equal {same}; rows 0 and 0-1 == their "
              f"B=1 and B=2 calls {batch}; cold in a "
              f"graph ({n} distinct weights), ms a launch: B=4 kernel "
              f"{rec['B4']['ms']:.4f}, torch.matmul "
              f"{rec['B4']['library_ms']:.4f}, bound "
              f"{rec['B4']['bound_ms']:.6f} ({rec['B4']['bound_by']}); "
              f"B=1 kernel {rec['B1']['ms']:.4f}, torch.matmul "
              f"{rec['B1']['library_ms']:.4f}, bound "
              f"{rec['B1']['bound_ms']:.6f}")
        mvm_rec[f"{X}x{N}"] = rec
    torch.cuda.empty_cache()
    for arch, layers, _ in DECODER_RUNS:
        cfg = _dense_config(arch, layers)
        mix = _step_mvm_shapes(cfg)
        for B in (4, 1):
            k = sum(mvm_rec[f"{X}x{N}"][f"B{B}"]["ms"] for X, N in mix)
            lib = sum(mvm_rec[f"{X}x{N}"][f"B{B}"]["library_ms"]
                      for X, N in mix)
            b = sum(mvm_rec[f"{X}x{N}"][f"B{B}"]["bound_ms"] for X, N in mix)
            print(f"kernels: mvm {cfg.name} (L={cfg.n_layers}) decode step, "
                  f"{len(mix)} launches summed from the cold per-shape "
                  f"times at B={B}: kernel {k:.3f} ms, torch.matmul "
                  f"{lib:.3f} ms, bound {b:.3f} ms; kernel / bound "
                  f"{k / b:.2f}")
            mvm_rec.setdefault("steps", {})[f"{arch} B{B}"] = dict(
                ms=k, library_ms=lib, bound_ms=b)
    ctx["mvm_dense"] = mvm_rec
    ctx.setdefault("mvm", {})["max_abs_err"] = max(
        ctx.get("mvm", {}).get("max_abs_err", 0.0), mvm_err)

    attn, served = {}, {}
    for arch, layers, _ in DECODER_RUNS:
        cfg = _dense_config(arch, layers)
        if "attn" not in cfg.layer_kinds():
            continue
        key = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
        attn.setdefault(key, []).append(arch)
        for bt in _dense_served(cfg):
            served.setdefault(key, [])
            if bt not in served[key]:
                served[key].append(bt)
    T = DENSE_ATTN_T
    attn_rec, attn_err = {}, 0.0
    for (Hk, G, D), archs in attn.items():
        Hq = Hk * G
        # at DENSE_ATTN_T: B = 4 mixed and full, B = 1 full and 33 live;
        # at each (B, Tb) serve_dense decodes on: a full ring and the edge
        # valid counts of the kernel's tiles there (1, a tile +- 1, the end
        # of the cluster's first round of tiles +- 1, Tb - 1), B rows a call
        cases = [(4, T, [1, 700, 2900, T]), (4, T, [T] * 4), (1, T, [T]),
                 (1, T, [33])]
        for B, Tb in served[(Hk, G, D)]:
            R = aops.splits(Tb) * aops.TILE
            edges = sorted({v for v in (1, aops.TILE, aops.TILE + 1, R - 1,
                                        R, R + 1, Tb - 1) if 1 <= v <= Tb})
            edges += [Tb] * (-len(edges) % B)
            cases.append((B, Tb, [Tb] * B))
            cases += [(B, Tb, edges[i:i + B])
                      for i in range(0, len(edges), B)]
        worst = 0.0
        for i, (B, Tb, valid) in enumerate(cases):
            args = _attn_case(B, Tb, Hq, Hk, D, bf16, valid, 130 + i, dev)
            ref = aops.decode_attention_plain(
                *args, block_t=aops.default_block_t(Tb))
            out, again = aops.decode_attention(*args), \
                aops.decode_attention(*args)
            torch.cuda.synchronize()
            share = _attn_share(out, ref)
            check(share <= 1.0, f"decode_attention Hk={Hk} G={G} D={D} B={B} "
                                f"T={Tb} valid={valid} disagrees with its "
                                f"plain version: {share:.3f} of the limit")
            check(bool(torch.equal(out, again)), f"decode_attention Hk={Hk} "
                  f"G={G} D={D} B={B} T={Tb}: two runs differ")
            worst = max(worst, share)
            attn_err = max(attn_err, max_err((out,), (ref,)))
        n_cl = aops.max_clusters(4, T, Hk, G, D)
        rec = {"archs": archs, "worst_share": worst, "branch": _attn_branch(D),
               "clusters": n_cl, "served": served[(Hk, G, D)],
               "cases": len(cases)}
        for B in (4, 1):
            # distinct ring pairs, together more than L2 holds at this B
            n = max(8, math.ceil(1.25 * L2_BYTES / (2 * B * T * Hk * D * 2)))
            sets = [[torch.randn(shape, generator=gen, device=dev,
                                 dtype=bf16)
                     for shape in ((B, Hq, D), (B, T, Hk, D), (B, T, Hk, D))]
                    for _ in range(n)]
            sdpa = [(qq[:, :, None], kk.transpose(1, 2).contiguous(),
                     vv.transpose(1, 2).contiguous()) for qq, kk, vv in sets]
            vl = torch.full((B,), T, dtype=torch.int32, device=dev)
            mask = torch.ones((B, 1, 1, T), dtype=torch.bool, device=dev)
            k_ms = graph_ms(lambda: [aops.decode_attention(qq, kk, vv, vl)
                                     for qq, kk, vv in sets]) / n
            p_ms = graph_ms(lambda: [aops.decode_attention_plain(
                qq, kk, vv, vl, block_t=aops.default_block_t(T))
                for qq, kk, vv in sets], trials=3) / n
            l_ms = graph_ms(lambda: [F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
                for qs, ks, vs in sdpa]) / n
            live = B * T
            nbytes = 2 * (2 * live * Hk * D + 2 * B * Hq * D) + 4 * B
            b_ms, b_by = bound(nbytes, 4 * live * Hq * D, "bf16")
            rec[f"B{B}"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by, rings=n)
            del sets, sdpa
        print(f"kernels: decode_attention Hq={Hq} Hk={Hk} G={G} D={D} "
              f"bf16 T={T} ({', '.join(archs)}; {rec['branch']}; S="
              f"{aops.splits(T)}; cudaOccupancyMaxActiveClusters {n_cl} at "
              f"B=4): worst head at {worst:.3f} of its limit over "
              f"{len(cases)} calls (at T={T}: B=4 mixed / full, B=1 full / "
              f"33 live; served (B, T) {served[(Hk, G, D)]} with S="
              f"{[aops.splits(t) for _, t in served[(Hk, G, D)]]}: full "
              f"rings and the tiles' edge valid counts); cold in a graph on "
              f"{rec['B4']['rings']} (B=4) / {rec['B1']['rings']} (B=1) "
              f"distinct rings, full ring, ms a launch: B=4 kernel "
              f"{rec['B4']['ms']:.4f}, plain {rec['B4']['plain_ms']:.4f}, "
              f"F.scaled_dot_product_attention {rec['B4']['library_ms']:.4f}, "
              f"bound {rec['B4']['bound_ms']:.6f} ({rec['B4']['bound_by']}), "
              f"kernel / bound {rec['B4']['ms'] / rec['B4']['bound_ms']:.2f}; "
              f"B=1 kernel {rec['B1']['ms']:.4f}, plain "
              f"{rec['B1']['plain_ms']:.4f}, SDPA "
              f"{rec['B1']['library_ms']:.4f}, bound "
              f"{rec['B1']['bound_ms']:.6f}")
        attn_rec[f"Hk{Hk} G{G} D{D}"] = rec
    torch.cuda.empty_cache()
    ctx["decode_attention_dense"] = attn_rec
    ctx.setdefault("decode_attention", {})["max_abs_err"] = max(
        ctx.get("decode_attention", {}).get("max_abs_err", 0.0), attn_err)


REQUESTS = (30, 30, 17, 45, 8, 30)


def _serve(device, params, frames, family="lstm", **engine_kw):
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    eng = RecurrentServingEngine(BYSDNE, params, max_batch=4,
                                 rnn_family=family, device=device,
                                 **engine_kw)
    for uid, fr in enumerate(frames):
        eng.submit(RecurrentRequest(uid=uid, frames=fr, max_new_frames=8))
    return eng, sorted(eng.run_to_completion(), key=lambda c: c.uid)


def _serve_and_check(ctx, label, family, params, seq_k, dec_k,
                     **engine_kw):
    """Serve the 6 BYSDNE requests on the card through ``family``'s
    kernels (``seq_k`` per admission slot, ``dec_k`` per tick), check the
    launches and statuses, hold the outputs against a device="cpu"
    engine, and time a warm rerun.  ``engine_kw`` goes to the card's
    engines (the calib phase's measured cost model); the CPU engine runs
    the analytic default."""
    import numpy as np
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts

    rng = np.random.default_rng(0)
    frames = [(rng.standard_normal((t, BYSDNE.lstm_input)) * 0.5)
              .astype(np.float32) for t in REQUESTS]
    everything = entries()
    reset_counts(*everything)
    eng, done = _serve("cuda", params, frames, family, **engine_kw)
    torch.cuda.synchronize()
    seq_n, dec_n = seq_k.kernel_launches, dec_k.kernel_launches
    others = sum(f.calls for f in everything if f not in (seq_k, dec_k))
    st = eng.compiled.stats
    print(f"{label}: {len(done)} requests, statuses "
          f"{[c.status for c in done]}, {eng.prefill_waves} waves "
          f"({eng.packed_launches} planned launches), {eng.decode_ticks} "
          f"ticks ({eng.decode_launches} planned launches); kernel "
          f"launches {seq_k.__name__} {seq_n}, {dec_k.__name__} {dec_n}; "
          f"degraded {st.degraded_launches}, fallback level "
          f"{st.fallback_level}")
    check(all(c.status == "ok" for c in done), "a request did not finish ok")
    check(eng.prefill_waves == 2, "expected two admission waves")
    check(seq_n + dec_n == eng.packed_launches + eng.decode_launches,
          "kernel launches != the plans' launches")
    check(seq_n == eng.packed_launches and dec_n == eng.decode_ticks
          and eng.decode_launches == eng.decode_ticks,
          f"a decode tick did not take exactly one {dec_k.__name__} launch")
    check((seq_k.calls, dec_k.calls) == (seq_n, dec_n) and others == 0,
          "an entry point ran without launching its kernel, or another "
          "family's kernel was called")
    check(st.degraded_launches == 0 and st.fallback_level == 0,
          "a launch degraded down the guarded ladder")
    if engine_kw.get("cost_model") == "measured":
        print(f"{label}: measured cost model: {st.measured_hits} hits "
              f"(with interpolated), {st.analytic_fallbacks} analytic "
              f"fallbacks")
        check(st.measured_hits > 0,
              "the measured cost model priced no launch from its table")
    tally(ctx, seq_k, dec_k)

    _, cpu_done = _serve("cpu", params, frames, family)
    err = max(max(float(np.abs(g.outputs - c.outputs).max()),
                  float(np.abs(g.generated - c.generated).max()))
              for g, c in zip(done, cpu_done))
    shapes_ok = all(g.outputs.shape == (t, BYSDNE.lstm_hidden)
                    and g.generated.shape == (8, BYSDNE.lstm_hidden)
                    and np.isfinite(g.outputs).all()
                    and np.isfinite(g.generated).all()
                    for g, t in zip(done, REQUESTS))
    print(f"{label}: outputs and generated frames vs the device=\"cpu\" "
          f"engine: max_abs_err {err:.3e} (tol {TOL_E2E:g}); shapes and "
          f"finiteness {'ok' if shapes_ok else 'WRONG'}")
    check(shapes_ok, "served outputs have the wrong shape or are not finite")
    check(err <= TOL_E2E, "served outputs disagree with the CPU path")

    t0 = time.perf_counter()
    eng2, _ = _serve("cuda", params, frames, family, **engine_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames_out = sum(t + 8 for t in REQUESTS)
    ctx[f"{label}_s"] = wall
    print(f"{label}: warm rerun {wall * 1e3:.1f} ms wall for "
          f"{len(REQUESTS)} requests ({frames_out} prompt + generated "
          f"frames, {eng2.packed_launches + eng2.decode_launches} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(
            lambda: _serve("cuda", params, frames, family, **engine_kw),
            label)
        _profiled_launches(label, seq_k.__name__, by_name, count, seq_n)


def phase_serve(ctx):
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    _serve_and_check(ctx, "serve", "lstm", _bysdne("lstm"), lstm_seq,
                     lstm_decode)


def phase_forward(ctx):
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import eesen_demo
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    cfg = eesen_demo()
    xs = (np.random.default_rng(1).standard_normal((4, 300, 340)) * 0.5
          ).astype(np.float32)
    cs = rnn.compile(cfg, device="cuda", seed=0)
    reset_counts(*entries())
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = lstm_seq.kernel_launches, cs.plan.launches
    print(f"forward: EESEN B=4 T=300 -> {tuple(ys.shape)} under "
          f"{cs.device_model.name}'s model: plan {_plan_items(cs.plan)}; "
          f"lstm_seq kernel launches {n}, plan.launches {p}, lstm_decode "
          f"{lstm_decode.kernel_launches}; degraded "
          f"{cs.stats.degraded_launches}")
    check(tuple(ys.shape) == (4, 300, 680), "wrong forward output shape")
    check(bool(torch.isfinite(ys).all()), "forward output not finite")
    check(n == p == lstm_seq.calls and lstm_decode.kernel_launches == 0,
          "forward launches != plan.launches")
    check(cs.stats.degraded_launches == 0 and cs.stats.fallback_level == 0,
          "a forward launch degraded down the guarded ladder")
    tally(ctx, lstm_seq)

    ref = rnn.compile(cfg, device="cpu", seed=0).forward(xs)
    err = float((ys.cpu() - ref).abs().max())
    print(f"forward: vs the CPU path max_abs_err {err:.3e} (tol "
          f"{TOL_E2E:g})")
    check(err <= TOL_E2E, "forward output disagrees with the CPU path")
    _check_ladder_on_card(cfg, xs, ys)

    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["forward_s"] = time.perf_counter() - t0
    print(f"forward: warm rerun {ctx['forward_s'] * 1e3:.1f} ms wall "
          f"({p} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs), "forward")
        _profiled_launches("forward", "lstm_seq", by_name, count, p)
    _forward_turns(ctx, cfg, xs, cs, ys)


def _plan_items(plan):
    """A plan's (schedule, block_t) per item."""
    return [(ip.schedule, ip.block_t) for ip in plan.items]


def _turns(runs: dict, order: tuple, rounds: int = 3) -> dict:
    """Warm walls (ms, host clock around work that ends in a synchronize)
    of each of ``runs`` (name -> callable), in ``order`` per round."""
    import torch

    walls = {name: [] for name in runs}
    for _ in range(rounds):
        for name in order:
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return walls


def _forward_turns(ctx, cfg, xs, cs, ys):
    """EESEN's plan under the card's model beside ExecutionPolicy(
    block_t=8), the plan the reference's VMEM budget leaves it: outputs
    held together, warm walls in turns (model, bt8, bt8, model) x3."""
    import torch

    from repro_torch import rnn

    pinned = rnn.compile(cfg, rnn.ExecutionPolicy(block_t=8),
                         device="cuda", seed=0)
    y8 = pinned.forward(xs)
    torch.cuda.synchronize()
    err = float((y8 - ys).abs().max())
    check(err <= TOL_FP32, "the bt8 plan's forward disagrees with the "
                           "card model's plan")
    walls = _turns({"model": lambda: cs.forward(xs),
                    "bt8": lambda: pinned.forward(xs)},
                   ("model", "bt8", "bt8", "model"))
    med = {k: statistics.median(v) for k, v in walls.items()}
    ctx["forward_turns"] = {
        "model_items": _plan_items(cs.plan),
        "model_launches": cs.plan.launches,
        "bt8_items": _plan_items(pinned.plan),
        "bt8_launches": pinned.plan.launches, "walls_ms": walls,
        "max_abs_err": err}
    print(f"forward: the card model's plan {_plan_items(cs.plan)} "
          f"({cs.plan.launches} launches) beside block_t=8 "
          f"{_plan_items(pinned.plan)} ({pinned.plan.launches} launches): "
          f"max_abs_err {err:.3e} (tol {TOL_FP32:g}); warm walls in turns "
          f"(model, bt8, bt8, model) x3: model median {med['model']:.2f} ms "
          f"{['%.2f' % w for w in walls['model']]}, bt8 median "
          f"{med['bt8']:.2f} ms {['%.2f' % w for w in walls['bt8']]}")


def _check_ladder_on_card(cfg, xs, healthy):
    """The guarded ladder on CUDA tensors holds kernel rungs only: a fault
    injected at the fused launch of slot 0 recovers through the per-step
    kernel launches, and one injected past per-step is raised instead of
    being computed in plain PyTorch.  Runs after the counted main path."""
    import torch

    from repro_torch import rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    from repro_torch.runtime.errors import LaunchError

    cs = rnn.compile(cfg, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cuda", seed=0)
    cs.fault.arm([0], through_level=0)
    reset_counts(lstm_seq)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    err = float((ys - healthy).abs().max())
    launched = lstm_seq.kernel_launches == lstm_seq.calls
    cs.fault.arm([0], through_level=1)
    try:
        cs.forward(xs)
        raised = None
    except LaunchError as fault:
        raised = fault.level
    print(f"forward: guarded ladder on the card: a fused fault recovers "
          f"through per-step kernel launches (degraded "
          f"{cs.stats.degraded_launches}, level {cs.stats.fallback_level}, "
          f"max_abs_err {err:.3e} vs the healthy run, every call launched "
          f"{launched}); a fault past per-step raises at level {raised!r}")
    check(cs.stats.degraded_launches == 1 and cs.stats.fallback_level == 1
          and launched and err <= TOL_FP32,
          "the per-step rung did not recover a fused fault with kernels")
    check(raised == "per_step",
          "a fault past per-step did not raise on the card")


#: the paper phase's shapes: RLDRADSPR's forward (B, T), GMAT's served
#: prompts (count, frames, decoded frames), and the lstm_seq launch whose
#: element offsets pass 2^31 (B, T at H = 1024) with the number of
#: launches its witness walks the same steps in
PAPER_FORWARD = (4, 400)
PAPER_SERVE = (4, 75, 8)
PAPER_OFFSETS = (16, 132096, 8)
# the paper phase's weights: the fan-in init times this gain per family.
# At fan-in init an LSTM layer's h is about half the size of its input, so
# the top of a 10- or 17-layer stack falls to 1e-4 .. 1e-6, under TOL_E2E,
# where a check in absolute terms cannot tell a right output from zeros.
# Twice the fan-in weights keep every LSTM layer's h of order 0.5; a GRU
# layer keeps its h of order 0.1 .. 1 at fan-in.  The phase prints each
# output's max |ref|.
PAPER_GAIN = {"lstm": 2.0, "gru": 1.0}
# the paper phase against the CPU path: besides TOL_E2E, max_abs_err
# within this share of the output's max |ref|: the same weights (GMAT's
# bf16 values on both sides) and fp32 arithmetic, products summed in other
# orders over up to 400 steps x 17 layers.  A stack with a layer skipped
# is planted against the same limit and must fail it.
TOL_REL = 1e-4


def phase_paper(ctx):
    """The paper's H=1024 networks (Table 5) through the main path at full
    width under the card's device model."""
    _paper_forward(ctx, "lstm")
    _paper_forward(ctx, "gru")
    _paper_serve(ctx)
    _paper_offsets(ctx)


def _paper_params(cfg, family, dtype):
    """``cfg``'s stack as ``family`` from a seeded torch.Generator (as
    rnn.compile draws it), W and U times PAPER_GAIN[family]."""
    import torch

    from repro_torch.core.gru import init_gru_stack
    from repro_torch.models.layers.lstm import init_lstm_stack

    gen = torch.Generator().manual_seed(0)
    if family == "lstm":
        params = init_lstm_stack(gen, cfg, torch.float32)
    else:
        params = init_gru_stack(gen, cfg.lstm_input, cfg.lstm_hidden,
                                cfg.n_layers, torch.float32)
    g = PAPER_GAIN[family]
    return {"layers": [{k: (v * g if k in ("W", "U") else v).to(dtype)
                        for k, v in layer.items()}
                       for layer in params["layers"]]}


def _paper_held(label, what, err, ref_max, rel_tol):
    """Print ``what``'s max_abs_err beside max |ref| and hold it within
    TOL_E2E and ``rel_tol`` of max |ref|."""
    rel = err / ref_max
    print(f"{label}: {what} max_abs_err {err:.3e}, max|ref| {ref_max:.3e}, "
          f"ratio {rel:.3e} (tol {TOL_E2E:g}, ratio {rel_tol:g})")
    check(err <= TOL_E2E and rel <= rel_tol,
          f"{label}: {what} disagrees with the CPU path")


def _paper_planted(label, what, err, ref_max, rel_tol):
    """A planted fault (a layer skipped) must fail the check that the
    right output passes."""
    rel = err / ref_max
    caught = err > TOL_E2E or rel > rel_tol
    print(f"{label}: planted fault, {what}: max_abs_err {err:.3e}, ratio "
          f"{rel:.3e} against the CPU path (tol {TOL_E2E:g}, ratio "
          f"{rel_tol:g}): caught {caught}")
    check(caught, f"{label}: the check passed a planted fault ({what})")


def _paper_forward(ctx, family):
    """rnn.compile(RLDRADSPR) forward as ``family`` (fp32 weights,
    ``_paper_params``): launches, degraded launches and outputs against
    the CPU path (the reference's model, unverified: its VMEM budget
    refuses every H=1024 slot), and a planted fault: the stack without its
    last layer on the card."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import RLDRADSPR
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_seq

    label = f"paper RLDRADSPR {family}"
    cfg = dataclasses.replace(RLDRADSPR, dtype="float32")
    B, T = PAPER_FORWARD
    xs = (np.random.default_rng(3).standard_normal(
        (B, T, cfg.lstm_input)) * 0.5).astype(np.float32)
    seq_k = lstm_seq if family == "lstm" else gru_seq
    params = _paper_params(cfg, family, torch.float32)
    cs = rnn.compile(params, device="cuda")
    everything = entries()
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = seq_k.kernel_launches, cs.plan.launches
    others = sum(f.calls for f in everything if f is not seq_k)
    st = cs.stats
    print(f"{label}: L={cfg.n_layers} H={cfg.lstm_hidden} B={B} T={T} "
          f"(weights {PAPER_GAIN[family]:g}x fan-in) -> {tuple(ys.shape)}; "
          f"plan {_plan_items(cs.plan)}, {p} launches; {seq_k.__name__} "
          f"kernel launches {n}; other entry points {others}; degraded "
          f"{st.degraded_launches}")
    check(tuple(ys.shape) == (B, T, cfg.lstm_hidden)
          and bool(torch.isfinite(ys).all()),
          f"{label}: wrong shape or not finite")
    check(n == p == seq_k.calls and others == 0,
          f"{label}: launches != plan.launches")
    check(st.degraded_launches == 0 and st.fallback_level == 0,
          f"{label}: a launch degraded down the guarded ladder")
    tally(ctx, seq_k)

    cpu = rnn.compile(params, rnn.ExecutionPolicy(verify="off"),
                      device="cpu")
    t0 = time.perf_counter()
    ref = cpu.forward(xs)
    cpu_s = time.perf_counter() - t0
    err = float((ys.cpu() - ref).abs().max())
    ref_max = float(ref.abs().max())
    _paper_held(label, f"output vs the CPU path (plan "
                f"{_plan_items(cpu.plan)}, {cpu.plan.launches} launches, "
                f"{cpu_s:.1f} s)", err, ref_max, TOL_REL)
    skipped = rnn.compile({"layers": params["layers"][:-1]}, device="cuda")
    _paper_planted(label, f"the last of {cfg.n_layers} layers skipped",
                   float((skipped.forward(xs).cpu() - ref).abs().max()),
                   ref_max, TOL_REL)
    del skipped

    walls = _turns({"warm": lambda: cs.forward(xs)}, ("warm",))["warm"]
    ctx.setdefault("paper", {})[f"RLDRADSPR_{family}"] = {
        "items": _plan_items(cs.plan), "launches": p, "max_abs_err": err,
        "max_ref": ref_max, "warm_ms": walls}
    print(f"{label}: warm walls {['%.2f' % w for w in walls]} ms "
          f"({p} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs), label)
        _profiled_launches(label, seq_k.__name__, by_name, count, p)


def _paper_served_err(done, results, gen):
    """max |served - CPU path| over each request's prompt outputs and
    decoded frames, and max |CPU path|."""
    import numpy as np

    refs = [(results[i][0][0].float().numpy(), gen[i])
            for i in range(len(done))]
    err = max(max(float(np.abs(c.outputs - out).max()),
                  float(np.abs(c.generated - new).max()))
              for c, (out, new) in zip(done, refs))
    ref_max = max(max(float(np.abs(out).max()), float(np.abs(new).max()))
                  for out, new in refs)
    return err, ref_max


def _paper_serve(ctx):
    """RecurrentServingEngine serves GMAT (bf16 weights, ``_paper_params``)
    on the card; the CPU path is the same stack compiled on the CPU (the
    reference's model, unverified), prefilled and ticked as the engine
    does.  A planted fault: the stack without its last layer, served."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import GMAT
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    label = "paper GMAT serve"
    n_req, T, new = PAPER_SERVE
    params = _paper_params(GMAT, "lstm", torch.bfloat16)
    rng = np.random.default_rng(4)
    frames = [(rng.standard_normal((T, GMAT.lstm_input)) * 0.5)
              .astype(np.float32) for _ in range(n_req)]

    def serve(cfg=GMAT, stack=params):
        eng = RecurrentServingEngine(cfg, stack, max_batch=n_req,
                                     device="cuda")
        for uid, fr in enumerate(frames):
            eng.submit(RecurrentRequest(uid=uid, frames=fr,
                                        max_new_frames=new))
        return eng, sorted(eng.run_to_completion(), key=lambda c: c.uid)

    everything = entries()
    reset_counts(*everything)
    eng, done = serve()
    torch.cuda.synchronize()
    seq_n, dec_n = lstm_seq.kernel_launches, lstm_decode.kernel_launches
    others = sum(f.calls for f in everything
                 if f not in (lstm_seq, lstm_decode))
    st = eng.compiled.stats
    tick = eng.last_decode_plan
    print(f"{label}: L={GMAT.n_layers} H={GMAT.lstm_hidden} (weights "
          f"{PAPER_GAIN['lstm']:g}x fan-in), {n_req} "
          f"prompts of {T} frames, {new} decoded each: statuses "
          f"{[c.status for c in done]}; prefill plan "
          f"{_plan_items(eng.last_plan)[:1]} x{len(eng.last_plan.items)}, "
          f"{eng.packed_launches} launches in {eng.prefill_waves} wave(s); "
          f"{eng.decode_ticks} ticks, each plan {tick.items[0].schedule} "
          f"({tick.launches} launch, {len(tick.slots[0].groups)} layers "
          f"chained); kernel launches lstm_seq {seq_n}, lstm_decode "
          f"{dec_n}; other entry points {others}; degraded "
          f"{st.degraded_launches}")
    check(all(c.status == "ok" for c in done) and len(done) == n_req,
          f"{label}: a request did not finish ok")
    check(eng.prefill_waves == 1 and seq_n == lstm_seq.calls
          == eng.packed_launches, f"{label}: prefill launches != the plan's")
    check(dec_n == lstm_decode.calls == eng.decode_ticks == new
          and eng.decode_launches == eng.decode_ticks
          and tick.slots[0].chained
          and len(tick.slots[0].groups) == GMAT.n_layers,
          f"{label}: a tick did not take exactly one chained lstm_decode "
          f"launch over the {GMAT.n_layers} layers")
    check(others == 0, f"{label}: another entry point was called")
    check(st.degraded_launches == 0 and st.fallback_level == 0,
          f"{label}: a launch degraded down the guarded ladder")
    tally(ctx, lstm_seq, lstm_decode)

    cpu = rnn.compile(params, rnn.ExecutionPolicy(verify="off"),
                      device="cpu")
    results = cpu.prefill([torch.from_numpy(f)[None] for f in frames])
    state = {k: torch.cat([s[k].float() for _, s in results], dim=1)
             for k in ("h", "c")}
    y = torch.stack([ys[0, -1].float() for ys, _ in results])[:, None]
    generated = []
    for _ in range(new):
        y, state = cpu.decode(y, state)
        y = y.float()
        state = {k: v.float() for k, v in state.items()}
        generated.append(y[:, 0])
    gen = torch.stack(generated, dim=1).numpy()
    err, ref_max = _paper_served_err(done, results, gen)
    shapes_ok = all(c.outputs.shape == (T, GMAT.lstm_hidden)
                    and c.generated.shape == (new, GMAT.lstm_hidden)
                    and np.isfinite(c.outputs).all()
                    and np.isfinite(c.generated).all() for c in done)
    print(f"{label}: shapes and finiteness "
          f"{'ok' if shapes_ok else 'WRONG'}")
    check(shapes_ok, f"{label}: wrong shape or not finite")
    _paper_held(label, f"outputs and decoded frames vs the CPU path "
                f"(prefill plan {cpu.plan.launches} launches)", err,
                ref_max, TOL_REL)
    short = dataclasses.replace(GMAT, n_layers=GMAT.n_layers - 1)
    _, skipped = serve(short, {"layers": params["layers"][:-1]})
    _paper_planted(label, f"the last of {GMAT.n_layers} layers skipped",
                   _paper_served_err(skipped, results, gen)[0], ref_max,
                   TOL_REL)

    walls = _turns({"warm": serve}, ("warm",))["warm"]
    ctx.setdefault("paper", {})["GMAT_serve"] = {
        "prefill_items": _plan_items(eng.last_plan),
        "prefill_launches": eng.packed_launches, "ticks": eng.decode_ticks,
        "max_abs_err": err, "max_ref": ref_max, "warm_ms": walls}
    print(f"{label}: warm walls {['%.2f' % w for w in walls]} ms "
          f"({eng.packed_launches} + {eng.decode_launches} launches, "
          f"{n_req * (T + new)} prompt + decoded frames)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(serve, label)
        _profiled_launches(label, "lstm_seq", by_name, count, seq_n)
        _profiled_launches(label, "lstm_decode", by_name, count, dec_n)


def _paper_offsets(ctx):
    """One lstm_seq launch whose xw and hs element offsets pass 2^31 (the
    kernel computes them in size_t), bit for bit against the same walk in
    PAPER_OFFSETS[2] launches, in each of which every xw and hs offset is
    below 2^31.  Outside the counted runs."""
    import torch

    from repro_torch.kernels.lstm_cell.ops import lstm_seq

    B, T, parts = PAPER_OFFSETS
    H = 1024
    step = T // parts
    check((4 * B * T - 1) * H >= 2 ** 31 and (B * T - 1) * H >= 2 ** 31
          and T % parts == 0 and 4 * B * step * H <= 2 ** 31,
          "the offsets case does not pass 2^31 in one launch and stay "
          "below it in each part")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    U = (torch.randn((1, H, 4, H), generator=gen, device=dev) * 0.02
         ).to(torch.bfloat16)
    xw = torch.randn((1, B, T, 4, H), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    h, c = torch.zeros((1, B, H), device=dev), torch.zeros((1, B, H),
                                                           device=dev)
    t0 = time.perf_counter()
    hs, hT, cT = lstm_seq(U, xw, h, c)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = True
    for k in range(parts):
        part = slice(k * step, (k + 1) * step)
        hs_k, h, c = lstm_seq(U, xw[:, :, part].contiguous(), h, c)
        same = same and torch.equal(hs[:, :, part], hs_k)
        del hs_k
    same = same and torch.equal(hT, h) and torch.equal(cT, c)
    finite = bool(torch.isfinite(hs).all())
    print(f"paper offsets: lstm_seq B={B} T={T} H={H} (bf16 xw, fp32 h): "
          f"largest xw offset {(4 * B * T - 1) * H + H - 1}, hs "
          f"{(B * T - 1) * H + H - 1} (2^31 = {2 ** 31}); one launch "
          f"{one_s:.2f} s; == {parts} launches of {step} steps (largest "
          f"xw offset {4 * B * step * H - 1}) bit for bit {same}; finite "
          f"{finite}")
    check(same and finite, "a launch past 2^31 element offsets differs "
                           "from the same walk in launches below it")
    del hs, xw


def phase_serve_gru(ctx):
    """The serve phase's 6 requests through BYSDNE as a GRU."""
    from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq

    _serve_and_check(ctx, "serve_gru", "gru", _bysdne("gru"), gru_seq,
                     gru_decode)


def _mixed_stack(H: int, seed: int):
    """lstm/gru/lstm/gru at width H, bf16 weights from a seeded
    torch.Generator."""
    import torch

    from repro_torch.core.gru import init_gru_layer
    from repro_torch.models.layers.lstm import init_lstm_layer

    gen = torch.Generator().manual_seed(seed)
    return {"layers": [init(gen, H, H, torch.bfloat16) for init in (
        init_lstm_layer, init_gru_layer, init_lstm_layer, init_gru_layer)]}


def phase_offpath(ctx):
    """Off the packed timeline: per_step (lstm_cell), a mixed stack, and a
    research schedule, each held against the CPU path."""
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_seq

    everything = entries()
    xs = (np.random.default_rng(2).standard_normal((4, 30, 340)) * 0.5
          ).astype(np.float32)

    # (1) BYSDNE under per_step: one lstm_cell launch per (layer, step)
    pol = rnn.ExecutionPolicy(schedule="per_step")
    cs = rnn.compile(BYSDNE, pol, device="cuda", seed=0)
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = lstm_cell.kernel_launches, cs.plan.launches
    others = sum(f.calls for f in everything if f is not lstm_cell)
    print(f"offpath: per_step BYSDNE B=4 T=30 -> {tuple(ys.shape)}; "
          f"lstm_cell kernel launches {n}, calls {lstm_cell.calls}, "
          f"plan.launches {p}; other kernels called {others} times")
    check(n == p == lstm_cell.calls == 150 and others == 0,
          "per_step launches != plan.launches == 150")
    check(tuple(ys.shape) == (4, 30, 340) and bool(torch.isfinite(ys).all()),
          "per_step output has the wrong shape or is not finite")
    tally(ctx, lstm_cell)
    ref = rnn.compile(BYSDNE, pol, device="cpu", seed=0).forward(xs)
    err = float((ys.cpu() - ref).abs().max())
    print(f"offpath: per_step vs the CPU path max_abs_err {err:.3e} (tol "
          f"{TOL_E2E:g})")
    check(err <= TOL_E2E, "per_step output disagrees with the CPU path")
    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["per_step_s"] = time.perf_counter() - t0
    print(f"offpath: per_step warm rerun {ctx['per_step_s'] * 1e3:.1f} ms "
          f"wall ({p} launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs),
                                           "offpath per_step")
        _profiled_launches("offpath per_step", "lstm_cell", by_name, count,
                           p)

    # (2) a mixed lstm/gru/lstm/gru stack at H=340: forward, then one
    # decode tick resumed from its prefill state (L=4 per-layer launches)
    params = _mixed_stack(340, seed=3)
    cs = rnn.compile(params, device="cuda")
    cpu = rnn.compile(params, device="cpu")
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    fwd_n = (lstm_seq.kernel_launches, gru_seq.kernel_launches)
    check(sum(fwd_n) == cs.plan.launches
          and sum(f.calls for f in everything) == cs.plan.launches,
          "mixed forward launches != plan.launches")
    tally(ctx, lstm_seq, gru_seq)
    err = float((ys.cpu() - cpu.forward(xs)).abs().max())
    (ys, st), (cys, cst) = cs.prefill(xs), cpu.prefill(xs)
    reset_counts(*everything)
    y, st = cs.decode(ys[:, -1:], st)
    torch.cuda.synchronize()
    dec_n = (lstm_seq.kernel_launches, gru_seq.kernel_launches)
    tally(ctx, lstm_seq, gru_seq)
    cy, cst = cpu.decode(cys[:, -1:], cst)
    dec_err = max(float((y.cpu() - cy).abs().max()),
                  max(float((st[k].cpu() - cst[k]).abs().max())
                      for k in ("h", "c")))
    print(f"offpath: mixed lstm/gru/lstm/gru H=340 forward B=4 T=30: "
          f"lstm_seq {fwd_n[0]} + gru_seq {fwd_n[1]} launches == "
          f"plan.launches {cs.plan.launches}, vs CPU max_abs_err {err:.3e}; "
          f"decode tick: lstm_seq {dec_n[0]} + gru_seq {dec_n[1]} launches "
          f"(plan {cs.last_decode_plan.launches}), vs CPU max_abs_err "
          f"{dec_err:.3e} (tol {TOL_E2E:g})")
    check(err <= TOL_E2E and dec_err <= TOL_E2E,
          "the mixed stack disagrees with the CPU path")
    check(sum(dec_n) == cs.last_decode_plan.launches == 4,
          "the mixed decode tick did not take its 4 per-layer launches")

    # (3) a research schedule: plain PyTorch on the card, zero launches
    pol = rnn.ExecutionPolicy(schedule="unfolded")
    cs = rnn.compile(BYSDNE, pol, device="cuda", seed=0)
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    calls = sum(f.calls for f in everything)
    err = float((ys.cpu() - rnn.compile(BYSDNE, pol, device="cpu", seed=0)
                 .forward(xs)).abs().max())
    print(f"offpath: unfolded BYSDNE B=4 T=30: {calls} kernel calls "
          f"(plan.launches {cs.plan.launches}), vs CPU max_abs_err "
          f"{err:.3e} (tol {TOL_E2E:g})")
    check(calls == 0 == cs.plan.launches,
          "the unfolded research schedule launched a kernel")
    check(err <= TOL_E2E, "unfolded output disagrees with the CPU path")


def _bysdne(family: str, seed: int = 0):
    """BYSDNE (L=5, H=X=340) as ``family``, bf16 weights from a seeded
    torch.Generator."""
    import torch

    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.core.gru import init_gru_stack
    from repro_torch.models.layers.lstm import init_lstm_stack

    gen = torch.Generator().manual_seed(seed)
    if family == "lstm":
        return init_lstm_stack(gen, BYSDNE, torch.bfloat16)
    return init_gru_stack(gen, BYSDNE.lstm_input, BYSDNE.lstm_hidden,
                          BYSDNE.n_layers, torch.bfloat16)


def _stack(family: str, seed: int):
    """``_bysdne(family, seed)`` with layer l's U zeroed on every 8-row
    tile t with t % (l + 2) == 0 (H=340 has 43 tiles, the last one 4
    rows)."""
    from repro_torch.configs.sharp_lstm import BYSDNE

    params = _bysdne(family, seed)
    H = BYSDNE.lstm_hidden
    for l, layer in enumerate(params["layers"]):
        for t in range(0, -(-H // 8), l + 2):
            layer["U"][t * 8:(t + 1) * 8] = 0
    return params


def phase_rglru(ctx):
    """RecurrentGemma-2B's RG-LRU layer at full width through the
    dispatcher: one rglru_scan launch per L=1 item."""
    import numpy as np
    import torch

    from repro_torch import dispatch, rnn
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.models.layers.lstm import init_lstm_stack
    from repro_torch.models.layers.rglru import gate_inputs, init_rglru

    dev = rnn.resolve_device("cuda")  # also keeps the gate GEMMs out of TF32
    everything = entries()
    cfg = recurrentgemma_2b.config()
    W, B, T = cfg.rglru_width, 4, cfg.window
    params = init_rglru(torch.Generator().manual_seed(0), W, cfg.dtype)
    x = (np.random.default_rng(4).standard_normal((B, T, W)) * 0.5
         ).astype(np.float32)
    with torch.no_grad():
        la, gx = gate_inputs({k: v.to(dev) for k, v in params.items()},
                             torch.from_numpy(x).to(dev))
        cla, cgx = gate_inputs(params, torch.from_numpy(x))
    item = dispatch.WorkItem(uid=0, family="rglru", B=B, T=T, H=W, X=W, L=1)
    p = dispatch.plan([item])
    reset_counts(*everything)
    hs = dispatch.execute(p, {}, {0: (la, gx)})[0]
    torch.cuda.synchronize()
    n = rglru_scan.kernel_launches
    others = sum(f.calls for f in everything if f is not rglru_scan)
    print(f"rglru: {cfg.name} RG-LRU layer W={W} B={B} T={T} -> "
          f"{tuple(hs.shape)}; rglru_scan kernel launches {n}, calls "
          f"{rglru_scan.calls}, plan.launches {p.launches}; other kernels "
          f"called {others} times")
    check(n == rglru_scan.calls == p.launches == 1 and others == 0,
          "the rglru item did not take exactly one rglru_scan launch")
    tally(ctx, rglru_scan)
    check(tuple(hs.shape) == (B, T, W) and bool(torch.isfinite(hs).all()),
          "rglru output has the wrong shape or is not finite")
    ref = dispatch.execute(p, {}, {0: (cla, cgx)})[0]
    err = float((hs.cpu() - ref).abs().max())
    print(f"rglru: vs the device=\"cpu\" path (gate GEMMs and scan) "
          f"max_abs_err {err:.3e} (tol {TOL_E2E:g})")
    check(err <= TOL_E2E, "rglru output disagrees with the CPU path")

    full = dispatch.WorkItem.from_config(cfg, T, B=B)
    try:
        dispatch.execute(dispatch.plan([full]), {}, {})
        refused = False
    except NotImplementedError:
        refused = True
    print(f"rglru: the whole model's item (L={full.L}) is plan-only: "
          f"execute refuses it {refused}")
    check(full.L == 18 and refused, "the L=18 rglru item was not refused")

    # one BYSDNE LSTM item and the rglru item in one plan and one execute
    lstm = init_lstm_stack(torch.Generator().manual_seed(0), BYSDNE,
                           torch.bfloat16)
    xl = (np.random.default_rng(5).standard_normal((B, 30, 340)) * 0.5
          ).astype(np.float32)
    mixed = dispatch.plan([
        dispatch.WorkItem(uid=0, family="lstm", B=B, T=30, H=340, X=340,
                          L=5),
        dispatch.WorkItem(uid=1, family="rglru", B=B, T=T, H=W, X=W, L=1)])
    dparams = {0: {"layers": [{k: v.to(dev) for k, v in layer.items()}
                              for layer in lstm["layers"]]}}
    reset_counts(*everything)
    outs = dispatch.execute(mixed, dparams,
                            {0: torch.from_numpy(xl).to(dev), 1: (la, gx)})
    torch.cuda.synchronize()
    ns = (lstm_seq.kernel_launches, rglru_scan.kernel_launches)
    calls = sum(f.calls for f in everything)
    tally(ctx, lstm_seq, rglru_scan)
    cpu = dispatch.execute(mixed, {0: lstm},
                           {0: torch.from_numpy(xl), 1: (cla, cgx)})
    err = max(float((outs[k].cpu() - cpu[k]).abs().max()) for k in (0, 1))
    same = bool(torch.equal(outs[1], hs))
    print(f"rglru: mixed plan (BYSDNE lstm item + rglru item): lstm_seq "
          f"{ns[0]} + rglru_scan {ns[1]} launches == plan.launches "
          f"{mixed.launches}; rglru output equal to the lone item's {same}; "
          f"vs CPU max_abs_err {err:.3e} (tol {TOL_E2E:g})")
    check(sum(ns) == calls == mixed.launches and ns[1] == 1,
          "mixed plan launches != plan.launches")
    check(same and err <= TOL_E2E, "the mixed plan disagrees")

    t0 = time.perf_counter()
    dispatch.execute(p, {}, {0: (la, gx)})
    torch.cuda.synchronize()
    ctx["rglru_s"] = time.perf_counter() - t0
    print(f"rglru: warm rerun {ctx['rglru_s'] * 1e3:.2f} ms wall "
          f"(1 launch)")
    if ctx["profile"]:
        profile_breakdown(lambda: dispatch.execute(p, {}, {0: (la, gx)}),
                          "rglru")


def _precision_run(ctx, label, cs, cpu, xs, seq_k, variant):
    """forward on the card and on the CPU: launches == plan.launches, all
    of them ``seq_k`` launches in ``variant``, output within TOL_E2E."""
    import torch

    from repro_torch.kernels.common import reset_counts

    everything = entries()
    reset_counts(*everything)
    ys = cs.forward(xs)
    torch.cuda.synchronize()
    n, p = seq_k.kernel_launches, cs.plan.launches
    calls = sum(f.calls for f in everything)
    branches = dict(seq_k.variant_launches)
    tally(ctx, seq_k)
    err = float((ys.cpu() - cpu.forward(xs)).abs().max())
    print(f"precision: {label} forward B=4 T=30: {seq_k.__name__} "
          f"launches {n} {branches}, plan.launches {p}; vs CPU max_abs_err "
          f"{err:.3e} (tol {TOL_E2E:g})")
    check(n == p == calls and branches == {variant: n},
          f"{label}: forward launches != plan.launches in {variant}")
    check(bool(torch.isfinite(ys).all()) and err <= TOL_E2E,
          f"{label}: forward disagrees with the CPU path")


def phase_precision(ctx):
    """BYSDNE under int8 + block sparsity (forward, prefill, decode), int8
    alone and bf16 + block sparsity, as an LSTM and as a GRU."""
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    everything = entries()
    xs = (np.random.default_rng(6).standard_normal((4, 30, 340)) * 0.5
          ).astype(np.float32)
    kernels = {"lstm": (lstm_seq, lstm_decode), "gru": (gru_seq, gru_decode)}
    for family, (seq_k, dec_k) in kernels.items():
        params = _stack(family, seed=7)
        pol = rnn.ExecutionPolicy(precision="int8", sparsity="block")
        cs = rnn.compile(params, pol, device="cuda")
        cpu = rnn.compile(params, pol, device="cpu")
        label = f"{family} int8+block"
        _precision_run(ctx, label, cs, cpu, xs, seq_k, "int8+compact")

        reset_counts(*everything)
        ys, st = cs.prefill(xs)
        torch.cuda.synchronize()
        n, p = seq_k.kernel_launches, cs.plan.launches
        ok = (n == p == sum(f.calls for f in everything)
              and seq_k.variant_launches == {"int8+compact": n})
        tally(ctx, seq_k)
        cys, cst = cpu.prefill(xs)
        err = max([float((ys.cpu() - cys).abs().max())]
                  + [float((st[k].cpu() - cst[k]).abs().max()) for k in st])
        print(f"precision: {label} prefill: {seq_k.__name__} launches {n}, "
              f"plan.launches {p}; outputs and state vs CPU max_abs_err "
              f"{err:.3e} (tol {TOL_E2E:g})")
        check(ok, f"{label}: prefill launches != plan.launches")
        check(err <= TOL_E2E, f"{label}: prefill disagrees with the CPU path")

        y, cy = ys[:, -1:], cys[:, -1:]
        ticks, launched = 4, 0
        for _ in range(ticks):
            reset_counts(*everything)
            y, st = cs.decode(y, st)
            torch.cuda.synchronize()
            launched += dec_k.kernel_launches
            check(dec_k.kernel_launches == cs.last_decode_plan.launches == 1
                  and sum(f.calls for f in everything) == 1,
                  f"{label}: a decode tick did not take one "
                  f"{dec_k.__name__} launch")
            tally(ctx, dec_k)
            cy, cst = cpu.decode(cy, cst)
        err = max([float((y.cpu() - cy).abs().max())]
                  + [float((st[k].cpu() - cst[k]).abs().max()) for k in st])
        print(f"precision: {label} {ticks} decode ticks resumed from the "
              f"prefill state: {dec_k.__name__} launches {launched} (1 per "
              f"tick, the dense kernel on the fake-quantized U); last frame "
              f"and state vs CPU max_abs_err {err:.3e} (tol {TOL_E2E:g})")
        check(bool(torch.isfinite(y).all()) and err <= TOL_E2E,
              f"{label}: decode disagrees with the CPU path")

        for prec, sparsity, variant in (("int8", "none", "int8"),
                                        ("bf16", "block", "compact")):
            pol = rnn.ExecutionPolicy(precision=prec, sparsity=sparsity)
            _precision_run(ctx, f"{family} {prec}+{sparsity}",
                           rnn.compile(params, pol, device="cuda"),
                           rnn.compile(params, pol, device="cpu"), xs,
                           seq_k, variant)

    cs = rnn.compile(_stack("lstm", seed=7), rnn.ExecutionPolicy(
        precision="int8", sparsity="block"), device="cuda")
    cs.forward(xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.forward(xs)
    torch.cuda.synchronize()
    ctx["precision_s"] = time.perf_counter() - t0
    print(f"precision: lstm int8+block forward warm rerun "
          f"{ctx['precision_s'] * 1e3:.1f} ms wall ({cs.plan.launches} "
          f"launches)")
    if ctx["profile"]:
        by_name, count = profile_breakdown(lambda: cs.forward(xs),
                                           "precision")
        _profiled_launches("precision", "lstm_seq", by_name, count,
                           cs.plan.launches)
        # a decode tick resumed from the prefill state: the dense decode
        # kernel on the fake-quantized U (fp32 U under bf16 W)
        ys, st = cs.prefill(xs)
        profile_breakdown(lambda: cs.decode(ys[:, -1:], st),
                          "precision decode tick")


#: serve_lm's prompt lengths: prefill buckets 4, 32, 256, 1024 (naive
#: attention), 2048 (blockwise) and 64, with 1 + 5 + 44 + 76 + 52 + 0
#: remainder tokens through batch-1 decode steps; the 2100-token prompt's
#: remainder and generation wrap its 2048-slot rings
LM_PROMPTS = (5, 37, 300, 1100, 2100, 64)
LM_NEW = 16


def _lm_prompts(vocab, lengths, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _keep_sampled_logits(eng):
    """Wrap ``eng``'s sampler: every logits row it samples a token from is
    kept, by request uid, in the order of that request's tokens."""
    kept, admitting = {}, []
    sample, admit = eng._sample, eng._prefill_admitted

    def prefill_admitted(pairs):
        for slot, req in pairs:
            admitting[:] = [req.uid]
            admit([(slot, req)])
        admitting.clear()

    def sample_and_keep(logits):
        uids = admitting or [None if r is None else r.uid for r in eng.slots]
        for uid, row in zip(uids, logits):
            if uid is not None:
                kept.setdefault(uid, []).append(row.clone())
        return sample(logits)

    eng._prefill_admitted, eng._sample = prefill_admitted, sample_and_keep
    return kept


def _lm_serve(cfg, params, prompts, max_new, device, max_batch=4,
              max_seq=4096, hook=None, on_engine=None):
    """Serve ``prompts`` through a fresh ServingEngine; ``hook(kind, n,
    fn, graph=None, tokens=None)`` may wrap its decode steps (n = B; the
    step's DecodeGraph and tokens given) and prefills (n = tokens), and
    ``on_engine(engine)`` sees the engine before it serves.  Returns
    (engine, completions by uid, the sampled logits (tokens, vocab) by
    uid)."""
    import torch

    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                        device=device)
    kept = _keep_sampled_logits(eng)
    if on_engine is not None:
        on_engine(eng)
    if hook is not None:
        dec, pre = eng._decode, eng._prefill
        eng._decode = lambda g, t: hook("decode", t.shape[0],
                                        lambda: dec(g, t), g, t)
        eng._prefill = lambda p, t: hook("prefill", t.shape[1],
                                         lambda: pre(p, t))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=max_new))
    done = {c.uid: c for c in eng.run_to_completion()}
    return eng, done, {uid: torch.stack(rows) for uid, rows in kept.items()}


def _route_as(make):
    """A context in which ``models.layers.moe.route`` is ``make(route)``:
    ``make`` gets the real route and returns what stands in for it (a
    recorder that calls it, or a pinned route, _RouteLog)."""
    import contextlib

    from repro_torch.models.layers import moe

    @contextlib.contextmanager
    def routed():
        orig = moe.route
        moe.route = make(orig)
        try:
            yield
        finally:
            moe.route = orig

    return routed()


def _teacher_forced(cfg, params, prompt, completion, nudge=False):
    """The logits a full-sequence forward on the card gives at the
    positions the engine sampled from (prompt + generated tokens but the
    last); with ``nudge`` every input embedding value is moved to about
    its neighbouring bf16 value (x (1 + 2^-8), rounded), for the forward's
    own response to rounding (_xlstm_horizon).  Causal: tokens appended
    after them change nothing, so a length in (1024, 2048], where the
    blockwise path needs whole chunks, is padded to 2048 (local attention
    pads itself above the window)."""
    import torch

    from repro_torch.models import transformer as tf

    seq = list(prompt) + completion.tokens[:-1]
    S, L = len(seq), len(prompt)
    if tf.NAIVE_ATTN_MAX_SEQ < S < cfg.window:
        seq = seq + [0] * (cfg.window - S)
    tokens = torch.tensor(seq, dtype=torch.long, device="cuda")[None]
    with torch.inference_mode():
        if nudge:
            from repro_torch.models.layers.embedding import embed

            e = embed(params["head"], tokens, torch.bfloat16)
            e = (e.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
            logits, _, _ = tf.forward(cfg, params, embeds=e)
        else:
            logits, _, _ = tf.forward(cfg, params, tokens=tokens)
    out = logits[0, L - 1:L - 1 + len(completion.tokens)].clone()
    del logits
    return out


def _margin(logits):
    """Top-1 minus top-2 logit of each row."""
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _serve_checks(ctx, label, cfg, params, prompts, max_new, max_seq,
                  per_step, per_prefill, watch=None, on_engine=None,
                  reference=None, tol=TOL_LM):
    """Serve ``prompts`` once through ServingEngine(max_batch=4) on the
    card, every kernel count set to 0 just before, and hold the run to
    what both serve phases check: every request completes with all its
    ``max_new`` tokens; every decode step launches ``per_step`` and every
    prefill ``per_prefill`` kernels (mvm, decode_attention, rglru_scan),
    and no entry point runs its plain version or another family's kernel
    on the card; the prefill buckets and remainder steps follow the
    engine's rule; every decode step after the first at its batch size
    is a graph replay; each request's sampled logits are within ``tol``
    (TOL_LM by default) of a teacher-forced forward on the card, its
    greedy tokens that forward's argmax wherever the top-2 margin exceeds
    ``tol`` (``tol`` None: the logits' difference is printed, not held).
    The run's launches are tallied.  ``watch(kind, n, graph, tokens)``
    sees each call before it runs, and what it returns, if not None, is
    called after it; ``on_engine`` as ``_lm_serve`` takes it;
    ``reference(uid, prompt, completion)`` gives the logits each request
    is held against (_teacher_forced by default).  Each decode step is
    timed (host wall around a synchronize, and CUDA events).  Returns
    (engine, completions by uid, the sampled logits by uid,
    the decode steps [(B, wall ms, device ms, replayed)], the largest
    logit error, the run's wall seconds)."""
    import torch

    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan

    everything = entries()
    lm = (mvm, decode_attention, rglru_scan)
    calls, steps = [], []  # (kind, rows or tokens, launches of lm)

    def count_call(kind, n, fn, graph=None, tokens=None):
        after = watch(kind, n, graph, tokens) if watch is not None else None
        replay = graph is not None and graph.graph is not None
        before = [f.kernel_launches for f in lm]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        if kind == "decode":
            steps.append((n, (time.perf_counter() - t) * 1e3,
                          start.elapsed_time(end), replay))
        calls.append((kind, n, tuple(f.kernel_launches - b
                                     for f, b in zip(lm, before))))
        if after is not None:
            after()
        return out

    lengths = [len(p) for p in prompts]
    reset_counts(*everything)
    t0 = time.perf_counter()
    eng, done, logits = _lm_serve(cfg, params, prompts, max_new, "cuda",
                                  max_seq=max_seq, hook=count_call,
                                  on_engine=on_engine)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ticks = [c for c in calls if c[0] == "decode" and c[1] == 4]
    rem = [c for c in calls if c[0] == "decode" and c[1] == 1]
    pre = [c for c in calls if c[0] == "prefill"]
    others = sum(f.calls for f in everything if f not in lm)
    print(f"{label}: {len(done)} requests (prompts {lengths}) in "
          f"{wall_s:.2f} s; {len(pre)} prefills (buckets "
          f"{sorted(eng.prefill_lengths)}), {len(rem)} batch-1 remainder "
          f"decode steps, {len(ticks)} batched ticks; kernel launches mvm "
          f"{mvm.kernel_launches}, decode_attention "
          f"{decode_attention.kernel_launches}, rglru_scan "
          f"{rglru_scan.kernel_launches}; other kernels called {others} "
          f"times")
    check(sorted(done) == list(range(len(prompts)))
          and all(len(c.tokens) == max_new for c in done.values()),
          f"{label}: a request did not complete with all its tokens")
    check(all(c[2] == tuple(per_step) for c in ticks + rem),
          f"{label}: a decode step did not launch {tuple(per_step)} "
          f"kernels (mvm, decode_attention, rglru_scan): "
          f"{sorted(set(c[2] for c in ticks + rem))}")
    check(all(c[2] == tuple(per_prefill) for c in pre),
          f"{label}: a prefill did not launch {tuple(per_prefill)} kernels: "
          f"{sorted(set(c[2] for c in pre))}")
    check(all(f.calls == f.kernel_launches for f in lm) and others == 0,
          f"{label}: an entry point ran its plain version on the card, or "
          "another family's kernel was called")
    check(len(pre) == len(prompts) and len(rem) == sum(
        n - (1 << (n.bit_length() - 1)) for n in lengths),
        f"{label}: prefill buckets or remainder steps differ from the "
        "engine's rule")
    replays = (eng.tick_graph.replays, eng.single_graph.replays)
    print(f"{label}: graph replays {replays[0]} of {len(ticks)} batched "
          f"ticks and {replays[1]} of {len(rem)} batch-1 steps (the first "
          f"step at each batch size eager, then captured); launches a "
          f"replay adds: "
          + "; ".join(f"{name} " + ", ".join(
              f"{fn.__name__} {launches}"
              for fn, (_, launches) in graph.captured.items())
              for name, graph in (("tick", eng.tick_graph),
                                  ("batch-1", eng.single_graph))))
    check(replays == (len(ticks) - 1, len(rem) - 1),
          f"{label}: a decode step after the first at its batch size was "
          "not a graph replay")
    tally(ctx, *lm)

    # every generated token's logits against a teacher-forced forward on
    # the card (torch.matmul, the prefill attention paths, rglru_scan)
    err, flips, held = 0.0, 0, 0
    for uid, c in sorted(done.items()):
        ref = (reference(uid, prompts[uid], c) if reference is not None
               else _teacher_forced(cfg, params, prompts[uid], c))
        e = float((logits[uid] - ref).abs().max())
        err = max(err, e)
        check(bool(torch.isfinite(logits[uid]).all()),
              f"{label}: request {uid} has non-finite logits")
        if tol is None:
            print(f"{label}: request {uid} (prompt {len(prompts[uid])}): "
                  f"logits vs the teacher-forced forward max_abs_err "
                  f"{e:.3e}, not held (|logit| <= "
                  f"{float(ref.abs().max()):.2f})")
            continue
        margin = _margin(ref)
        sure = margin > tol
        agree = ref.argmax(-1).cpu() == torch.tensor(c.tokens)
        held += int(sure.sum())
        flips += int((~agree).sum())
        print(f"{label}: request {uid} (prompt {len(prompts[uid])}): "
              f"logits vs the teacher-forced forward max_abs_err {e:.3e} "
              f"(tol {tol:g}; |logit| <= "
              f"{float(ref.abs().max()):.2f}); greedy tokens == argmax at "
              f"{int(agree.sum())}/{len(agree)} positions, smallest top-2 "
              f"margin {float(margin.min()):.3e}")
        check(e <= tol, f"{label}: request {uid}'s logits disagree with "
                        f"the forward: {e:.3e} > {tol:g}")
        check(bool(agree[sure.cpu()].all()),
              f"{label}: request {uid}: a greedy token differs from the "
              f"forward's argmax where the top-2 margin exceeds {tol:g}")
        del ref
    if tol is not None:
        print(f"{label}: tokens held at {held} positions with a top-2 "
              f"margin above the logits' limit; {flips} near-tie positions "
              f"differ")
    return eng, done, logits, steps, err, wall_s


def _f3_layers(label, cfg, params, prompts, done, max_seq):
    """Each attention layer of the decode step against the forward (F3,
    _attn_layers_vs_forward), for every request served; returns the worst
    share of TOL_LAYER."""
    worst = 0.0
    for uid, c in sorted(done.items()):
        shares = _attn_layers_vs_forward(cfg, params, prompts[uid], c,
                                         max_seq=max_seq)
        worst = max(worst, max(shares))
        print(f"{label}: request {uid}: each attention layer's output at "
              f"the decoded positions vs the teacher-forced forward on the "
              f"same input, worst position over its limit (TOL_LAYER "
              f"{TOL_LAYER:g} of its largest |output|) by layer: "
              + ", ".join(f"{x:.3f}" for x in shares))
        check(max(shares) <= 1.0, f"{label}: request {uid}: an attention "
              f"layer of the decode step disagrees with the forward: "
              f"{max(shares):.3f} of TOL_LAYER")
    return worst


def phase_serve_lm(ctx):
    """RecurrentGemma-2B at full width through serving.ServingEngine: the
    decode steps on mvm + decode_attention, the prefills on rglru_scan."""
    import statistics as stats

    import torch

    from repro_torch import rnn
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine

    dev = rnn.resolve_device("cuda")
    # fp32 products in full fp32: the unembed's logits and the plain
    # versions (resolve_device sets the matmul flag; cuDNN's is stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = recurrentgemma_2b.config()
    kinds = cfg.layer_kinds()
    n_attn, n_rglru = kinds.count("attn"), kinds.count("rglru")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    ctx["serve_lm_init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve_lm: {cfg.name} L={cfg.n_layers} ({n_rglru} rglru, "
          f"{n_attn} attn) d_model={cfg.d_model} vocab={cfg.vocab_size} "
          f"{cfg.dtype}: {n_params:,} parameters drawn on the card in "
          f"{ctx['serve_lm_init_s']:.2f} s")

    prompts = _lm_prompts(cfg.vocab_size, LM_PROMPTS, seed=8)
    lm = (mvm, decode_attention, rglru_scan)
    wrapped = []  # the first batched tick with a wrapped ring, before it

    def watch(kind, n, graph, tokens):
        if (kind == "decode" and n == 4 and not wrapped
                and int(graph.cache["idx"].max()) >= cfg.window):
            wrapped.append((graph, _clone_cache(graph.cache),
                            tokens.clone()))

    _, done, _, _, ctx["serve_lm_err"], _ = _serve_checks(
        ctx, "serve_lm", cfg, params, prompts, LM_NEW, 4096,
        (6 * cfg.n_layers, n_attn, 0), (0, 0, n_rglru), watch)
    check(len(wrapped) == 1, "serve_lm: no batched tick ran on a wrapped "
                             "ring")
    ctx["serve_lm_engine_rings_share"] = _attn_on_engine_rings(
        cfg, *wrapped[0])
    del wrapped[:]
    ctx["serve_lm_layer_share"] = _f3_layers("serve_lm", cfg, params,
                                             prompts, done, 4096)

    _planted_faults(cfg, params, prompts)
    _depth_vs_cpu(cfg, params, 3, "serve_lm")

    # a warm run, each decode step and prefill timed on the host clock
    # around a synchronize, and on the device by CUDA events around the
    # step (the token copy and the replay); the first replay at each batch
    # size is held against the step run eagerly (_replay_vs_eager), outside
    # its time
    times, checked = [], {}

    def timed(kind, n, fn, graph=None, tokens=None):
        replay = graph is not None and graph.graph is not None
        before = None
        if replay and graph not in checked:
            before = (_clone_cache(graph.cache),
                      tokens.to(dev, copy=True))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append((kind, n, (time.perf_counter() - t) * 1e3,
                      start.elapsed_time(end), replay))
        if before is not None:
            checked[graph] = _replay_vs_eager(graph, *before, n)
        return out

    t0 = time.perf_counter()
    warm, _, _ = _lm_serve(cfg, params, prompts, LM_NEW, "cuda", hook=timed)
    torch.cuda.synchronize()
    ctx["serve_lm_s"] = time.perf_counter() - t0
    check(len(checked) == 2, "serve_lm: the warm run did not replay both "
                             "decode graphs")
    ctx["serve_lm_replay_err"] = max(checked.values())
    pre_ms = {n: t for k, n, t, _, _ in times if k == "prefill"}
    ctx["serve_lm_prefill_ms"] = pre_ms
    for B, label, key, graph in (
            (4, "batched tick (B=4)", "tick", warm.tick_graph),
            (1, "batch-1 decode step", "step1", warm.single_graph)):
        busy_ms, kernel_ms = _profiled_replay(graph, B, lm,
                                              (6 * cfg.n_layers, n_attn, 0))
        ctx[f"serve_lm_{key}_kernel_ms"] = dict(
            zip((fn.__name__ for fn in lm), kernel_ms))
        steps = [(w, d, r) for k, n, w, d, r in times
                 if k == "decode" and n == B]
        wall = [w for w, _, r in steps if r]
        dev_ms = [d for _, d, r in steps if r]
        host = 1 - sum(dev_ms) / sum(wall)
        busy = busy_ms / stats.median(dev_ms)
        ctx[f"serve_lm_{key}_ms"] = stats.median(wall)
        ctx[f"serve_lm_{key}_device_ms"] = stats.median(dev_ms)
        ctx[f"serve_lm_{key}_host_share"] = host
        ctx[f"serve_lm_{key}_busy"] = busy
        first = [w for w, _, r in steps if not r]
        print(f"serve_lm: warm run, {label}: {len(wall)} replays, host wall "
              f"median {stats.median(wall):.3f} ms (min {min(wall):.3f}, "
              f"max {max(wall):.3f}), device span (CUDA events around the "
              f"step) median {stats.median(dev_ms):.3f} ms; host-overhead "
              f"share 1 - device span/wall = {100 * host:.1f}% (it cannot "
              f"see the device's gaps inside the span); device busy "
              f"{busy_ms:.3f} ms (one replay under the profiler) = "
              f"{100 * busy:.1f}% of the median span; the first step, "
              f"eager with the capture: "
              f"{first[0]:.1f} ms")
    gen = len(prompts) * LM_NEW
    print(f"serve_lm: warm run {ctx['serve_lm_s']:.3f} s wall for "
          f"{len(prompts)} requests ({sum(LM_PROMPTS)} prompt + {gen} "
          f"generated tokens); prefill ms by bucket "
          + ", ".join(f"{n}: {t:.1f}" for n, t in sorted(pre_ms.items())))
    if ctx["profile"]:
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=4096,
                            device="cuda")
        for uid, p in enumerate(_lm_prompts(cfg.vocab_size, (64,) * 4, 9)):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=64))
        eng.step()  # admission: four prefills, then the first tick
        torch.cuda.synchronize()
        profile_breakdown(lambda: [eng.step() for _ in range(8)],
                          "serve_lm 8 batched ticks")
        with torch.inference_mode():
            for n in (64, 2048):
                tokens = torch.as_tensor(
                    _lm_prompts(cfg.vocab_size, (n,), 11)[0],
                    dtype=torch.long, device="cuda")[None]
                prof = profile_breakdown(
                    lambda: eng._prefill(eng.params, tokens),
                    f"serve_lm prefill of {n} tokens")
                ms, k = device_share(*prof, "rglru_scan")
                print(f"serve_lm prefill of {n} tokens: rglru_scan {ms:.3f} "
                      f"ms of device time in {k} launches")
                check(k == n_rglru, f"serve_lm: the profiled prefill of {n} "
                      f"tokens ran {k} rglru_scan kernels, not {n_rglru}")
        del eng
    del params
    torch.cuda.empty_cache()


#: a kernel's name on the device, as the profiler reports it: every part
#: appears in it (the decode and sequence kernels share their cells)
DEVICE_NAMES = {"mvm": ("mvm_kernel",), "decode_attention": ("attn_kernel",),
                "rglru_scan": ("rglru_scan_kernel",),
                "rglru_scan_bwd": ("rglru_scan_bwd_kernel",),
                "lstm_cell": ("lstm_cell_kernel",),
                "lstm_decode": ("cluster_kernel", "LstmCell"),
                "gru_decode": ("cluster_kernel", "GruCell"),
                "lstm_seq": ("seq_kernel", "LstmCell"),
                "gru_seq": ("seq_kernel", "GruCell")}


def is_kernel(kernel: str, name: str) -> bool:
    """Whether the device kernel ``name`` is the port's ``kernel``."""
    return all(part in name for part in DEVICE_NAMES[kernel])


def _profiled_replay(graph, B, lm, per_step, label="serve_lm"):
    """One more replay of ``graph`` (the engine has drained, so its state
    is no longer read) under torch.profiler.  A replay's launch counts are
    bookkeeping (``DecodeGraph.replay`` adds what the capture counted), so
    here the device's own events are counted by kernel name and must equal
    the counts the replay added, the capture's record and ``per_step``
    (mvm, decode_attention, rglru_scan).  Returns the device's busy time
    in ms, the sum of its events (the profiler stretches the replay's
    span, CUDA events around it, so that is printed but not used), and
    each of those kernels' device ms in the replay."""
    import torch

    from repro_torch.kernels.common import reset_counts

    reset_counts(*lm)
    tokens = graph.tokens.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay():
        with torch.inference_mode():
            start.record()
            graph(tokens)
            end.record()

    torch.cuda.synchronize()
    _, by_name, count = device_events(replay)
    span_us = start.elapsed_time(end) * 1e3
    on_device = tuple(
        sum(n for name, n in count.items()
            if is_kernel(fn.__name__, name)) for fn in lm)
    booked = tuple(fn.kernel_launches for fn in lm)
    captured = tuple(graph.captured.get(fn, (0, 0))[1] for fn in lm)
    busy = sum(by_name.values()) / 1e3
    kernel_ms = tuple(
        sum(us for name, us in by_name.items()
            if is_kernel(fn.__name__, name)) / 1e3 for fn in lm)
    print(f"{label}: one replay at B={B} under the profiler: device events "
          f"{sum(count.values())}, by kernel (mvm, decode_attention, "
          f"rglru_scan) on the device {on_device}, counted by the replay "
          f"{booked}, recorded at capture {captured}; their device ms "
          + ", ".join(f"{x:.4f}" for x in kernel_ms)
          + f"; device busy {busy:.3f} ms in a span of "
          f"{span_us / 1e3:.3f} ms under the profiler; the largest by "
          f"device time (events): "
          + "; ".join(f"{name[:40]} {us / 1e3:.3f} ms ({count[name]})"
                      for name, us in by_name.most_common(4)))
    check(on_device == booked == captured == tuple(per_step),
          f"{label}: a replay at B={B} ran {on_device} kernels on the "
          f"device but counted {booked} (captured {captured}, expected "
          f"{tuple(per_step)})")
    return busy, kernel_ms


def _clone_cache(cache):
    from repro_torch.models import transformer as tf

    return {"layers": tf.map_layers(lambda t: t.clone(), cache["layers"]),
            "idx": cache["idx"].clone()}


def _replay_vs_eager(graph, cache, tokens, B):
    """The replay that just ran, against the same step run eagerly
    (``DecodeGraph.eager``) on ``cache``, a clone of the static cache as it
    was before the replay, with the same tokens.  Both run the same
    kernels on the same inputs, and cuBLAS is asked for the same products
    in and out of a capture, so the logits must be bit-equal
    (TOL_REPLAY).  Returns the max |difference|; its launches count
    nowhere (the warm run's counts are not read)."""
    import torch

    replayed = graph.logits.clone()
    eager = graph.eager(cache=cache, tokens=tokens)
    torch.cuda.synchronize()
    err = float((replayed - eager).abs().max())
    equal = bool(torch.equal(replayed, eager))
    print(f"serve_lm: the first replayed decode step at B={B} against the "
          f"step run eagerly on a clone of its cache: logits max_abs_err "
          f"{err:.3e}, bit-equal {equal} (tol {TOL_REPLAY:g})")
    check(err <= TOL_REPLAY, f"serve_lm: the graph replay at B={B} "
                             f"disagrees with the eager step: {err:.3e}")
    return err


def _off_the_forward(cfg, params, prompts, done, logits, tol):
    """How far a served run lies from the teacher-forced forward: the
    largest logit difference over its requests, and the count of greedy
    tokens that differ from the forward's argmax where its top-2 margin
    exceeds ``tol``."""
    import torch

    err, wrong = 0.0, 0
    for uid, c in sorted(done.items()):
        ref = _teacher_forced(cfg, params, prompts[uid], c)
        err = max(err, float((logits[uid] - ref).abs().max()))
        sure = (_margin(ref) > tol).cpu()
        agree = ref.argmax(-1).cpu() == torch.tensor(c.tokens)
        wrong += int((sure & ~agree).sum())
    return err, wrong


def _planted_faults(cfg, params, prompts):
    """The logit check above must see a wrong kernel: two requests (37 and
    64 prompt tokens, 8 new) are served once with each of two planted
    faults and held against the teacher-forced forward, which runs
    neither kernel.  The faults, planted at the entry points the model
    calls: mvm drops the last 64 of the X rows of every decode
    projection (a lost k-tile), and decode_attention drops the newest
    live slot (valid - 1, the token's own key).  Each must give logits
    beyond TOL_LM, or a greedy token that differs from the forward's
    argmax where its top-2 margin exceeds TOL_LM, and an attention layer
    beyond TOL_LAYER in the per-layer check (_attn_layers_vs_forward, the
    fault still planted), whose margin is printed beside the logits'.
    Launches here are outside the counted run."""
    import types

    import torch

    from repro_torch.models.layers import attention, common

    mvm, dattn = common.mvm, attention.decode_kernel.decode_attention
    faults = {
        "mvm drops the last 64 X rows": (
            common, "mvm",
            lambda x, W: mvm(x[:, :-64].contiguous(), W[:-64])),
        "decode_attention drops the newest slot": (
            attention, "decode_kernel", types.SimpleNamespace(
                decode_attention=lambda q, k, v, valid: dattn(
                    q, k, v, torch.clamp(valid - 1, min=1)))),
    }
    chosen = [prompts[LM_PROMPTS.index(n)] for n in (37, 64)]
    for name, (module, attr, planted) in faults.items():
        orig = getattr(module, attr)
        setattr(module, attr, planted)
        try:
            _, done, logits = _lm_serve(cfg, params, chosen, 8, "cuda")
            layers = max(max(_attn_layers_vs_forward(cfg, params, chosen[u],
                                                     c))
                         for u, c in done.items())
        finally:
            setattr(module, attr, orig)
        err, wrong = _off_the_forward(cfg, params, chosen, done, logits,
                                      TOL_LM)
        print(f"serve_lm: planted fault, {name}: logits vs the forward "
              f"max_abs_err {err:.3e} (tol {TOL_LM:g}, margin "
              f"{err / TOL_LM:.2f}x); {wrong} tokens differ where the top-2 "
              f"margin exceeds {TOL_LM:g}; the per-layer check's worst "
              f"attention layer at {layers:.2f}x its limit (TOL_LAYER "
              f"{TOL_LAYER:g})")
        check(err > TOL_LM or wrong > 0, f"serve_lm: the logit check "
              f"does not see the planted fault ({name})")
        check(layers > 1.0, f"serve_lm: the per-layer check does not see "
              f"the planted fault ({name})")


def _attn_on_engine_rings(cfg, graph, cache, tokens):
    """The kernel on the rings serving really produces: one batched tick
    run eagerly on ``cache``, a clone of the engine's cache taken before
    the first tick with a wrapped ring, records each attention layer's
    (q, rings, valid) as ``models.layers.attention.decode_attention``
    receives them; the kernel on each is held against
    decode_attention_plain under the per-(row, head) bf16 limit.  Returns
    the worst share of the limit."""
    import torch

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models.layers import attention

    seen = []
    orig = attention.decode_attention

    def record(q, k, v, valid, *, window=0):
        seen.append(tuple(t.clone() for t in (q, k, v, valid)))
        return orig(q, k, v, valid, window=window)

    attention.decode_attention = record
    try:
        with torch.inference_mode():
            graph.eager(cache=cache, tokens=tokens.to(cache["idx"].device))
    finally:
        attention.decode_attention = orig
    check(len(seen) == cfg.layer_kinds().count("attn"),
          f"serve_lm: the tick ran {len(seen)} attention layers")
    worst = 0.0
    with torch.inference_mode():
        for q, k, v, valid in seen:
            out = ops.decode_attention(q, k, v, valid)
            ref = ops.decode_attention_plain(
                q[:, 0], k, v, valid,
                block_t=ops.default_block_t(k.shape[1]))
            torch.cuda.synchronize()
            worst = max(worst, _attn_share(out[:, 0], ref))
    counts, T = seen[0][3].tolist(), seen[0][1].shape[1]
    print(f"serve_lm: decode_attention on the engine's own rings (a clone "
          f"of its cache before the first batched tick with a wrapped "
          f"ring, idx {cache['idx'].tolist()}, valid {counts}), "
          f"{len(seen)} attention layers: worst head at {worst:.3f} of its "
          f"limit (ULP_BF16 of the head's largest output)")
    check(len(set(counts)) > 1 and max(counts) == T,
          "serve_lm: the engine's rings are not a wrapped ring among rows "
          "of mixed valid")
    check(worst <= 1.0, f"serve_lm: decode_attention disagrees with its "
                        f"plain version on the engine's rings: {worst:.3f}")
    return worst


def _attn_layers_vs_forward(cfg, params, prompt, completion, max_seq=4096):
    """Each attention layer of the decode step against the teacher-forced
    forward, on the same input (F3).  The forward is run layer by layer
    with the model's own functions (``transformer._layer_apply``, the
    prefill attention paths; its length padded as in _teacher_forced);
    at each attention layer the block's output and keys and values over
    the whole sequence come from ``transformer._attn_block`` in prefill
    mode.  The decode step's block (``_attn_block`` in decode mode: mvm
    projections, the new slot written into the ring, the decode_attention
    kernel) then takes the forward's normed input at every position the
    engine decoded (the remainder prompt tokens and the generated ones),
    one row each, over the engine's ring (``tf.cache_len(cfg, max_seq)``
    slots: a window's ring, or the full length) holding the forward's keys
    and values of the positions before it where the engine's ring holds
    them (slot pos % T on a ring).  Layer i's parameters are
    ``tf.layer_view(params["layers"], i)``: an unrolled stack's entry or
    the stacked leaves' views.  Returns, per attention
    layer, the worst position's max |decode - forward| over TOL_LAYER x
    its largest |output|."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.common import param_dtype
    from repro_torch.models.layers.embedding import embed
    from repro_torch.models.layers.norm import rms_norm

    seq = list(prompt) + completion.tokens[:-1]
    S, L = len(seq), len(prompt)
    rows = list(range(1 << (L.bit_length() - 1), S))  # decoded positions
    if tf.NAIVE_ATTN_MAX_SEQ < S < cfg.window:
        seq = seq + [0] * (cfg.window - S)
    Sp = len(seq)
    T = tf.cache_len(cfg, max_seq)  # the engine's rings
    dev = torch.device("cuda")
    pos = torch.tensor(rows, device=dev)
    idx = pos.to(torch.int32)
    shares = []
    with torch.inference_mode():
        x = embed(params["head"], torch.tensor(seq, device=dev)[None],
                  param_dtype(cfg))
        rope = tf._rope_for(cfg, torch.arange(Sp, dtype=torch.int32,
                                              device=dev)[None])
        rope_dec = tf._rope_for(cfg, idx[:, None])
        for i, kind in enumerate(cfg.layer_kinds()):
            p = tf.layer_view(params["layers"], i)
            if kind == "attn":
                h = rms_norm(x, p["norm1"], cfg.norm_eps)
                o_fwd, kv = tf._attn_block(
                    cfg, p["attn"], h, rope,
                    {key: h.new_empty((1, Sp, cfg.kv_dim))
                     for key in ("k", "v")}, None, "prefill")
                ring = {key: h.new_zeros((len(rows), T, cfg.kv_dim))
                        for key in ("k", "v")}
                for r, t in enumerate(rows):
                    before = torch.arange(max(0, t - T + 1), t, device=dev)
                    for key in ("k", "v"):
                        ring[key][r, before % T] = kv[key][0, before]
                o_dec, _ = tf._attn_block(cfg, p["attn"], h[0, pos][:, None],
                                          rope_dec, ring, idx, "decode")
                ref = o_fwd[0, pos].float()
                err = (o_dec[:, 0].float() - ref).abs().amax(-1)
                limit = TOL_LAYER * ref.abs().amax(-1)
                shares.append(float((err / limit).max()))
                del ring, kv
            x, _, _ = tf._layer_apply(cfg, kind, p, x, rope, None, None,
                                      "train")
    return shares


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _depth_vs_cpu(cfg, params, n, label):
    """The first ``n`` layers at full width serve two short prompts on
    the card and in a device="cpu" engine: equal tokens (up to a near-tie,
    after which the two continue from other tokens) and logits within
    TOL_LM_DEPTH3."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg_n = dataclasses.replace(cfg, n_layers=n)
    p_n = dict(params, layers=tf.layer_view(params["layers"], slice(0, n)))
    prompts = _lm_prompts(cfg.vocab_size, (16, 40), seed=10)
    _, gpu, gpu_logits = _lm_serve(cfg_n, p_n, prompts, 4, "cuda",
                                   max_batch=2, max_seq=256)
    t0 = time.perf_counter()
    _, cpu, cpu_logits = _lm_serve(cfg_n, p_n, prompts, 4, "cpu", max_batch=2,
                                   max_seq=256)
    cpu_s = time.perf_counter() - t0
    err, compared = 0.0, 0
    for uid in sorted(gpu):
        g, c = gpu[uid], cpu[uid]
        for i, (tg, tc) in enumerate(zip(g.tokens, c.tokens)):
            e = float((gpu_logits[uid][i].cpu() - cpu_logits[uid][i])
                      .abs().max())
            err = max(err, e)
            compared += 1
            check(e <= TOL_LM_DEPTH3,
                  f"{label} depth {n}: request {uid} token {i}: logits on "
                  f"the card and the CPU differ by {e:.3e} > "
                  f"{TOL_LM_DEPTH3:g}")
            if tg != tc:
                m = float(_margin(cpu_logits[uid][i:i + 1])[0])
                print(f"{label} depth {n}: request {uid} token {i} differs "
                      f"at a top-2 margin of {m:.3e}; compared up to here")
                check(m <= TOL_LM_DEPTH3, f"{label} depth {n}: a token "
                      "differs between the card and the CPU")
                break
    on_card = [gpu[u].tokens for u in sorted(gpu)]
    on_cpu = [cpu[u].tokens for u in sorted(cpu)]
    print(f"{label}: depth {n} at full width, card vs device=\"cpu\" engine "
          f"({cpu_s:.1f} s on the CPU): tokens {on_card} vs {on_cpu}; "
          f"logits max_abs_err {err:.3e} over {compared} tokens (tol "
          f"{TOL_LM_DEPTH3:g})")
    return err


#: serve_dense: the token archs' four prompts (5-300 tokens, DENSE_NEW new
#: each; prefill buckets 4, 32, 128 and 256 with 1, 5, 12 and 44
#: remainder steps) in ServingEngine(max_batch=4), full-length rings of
#: DENSE_MAX_SEQ slots
DENSE_PROMPTS = (5, 37, 140, 300)
DENSE_NEW = 8
DENSE_MAX_SEQ = 512
#: h2o-danube's fifth prompt, served first: its 8192 bucket runs
#: local_attention and the roll into the 4096-slot window ring, and its 8
#: remainder steps and every batched tick run on a wrapped ring
DENSE_LONG = 8200
DENSE_LONG_MAX_SEQ = 8216
#: the archs whose decode step is held layer by layer against the forward
#: (F3, _attn_layers_vs_forward)
DENSE_F3 = ("stablelm-12b", "h2o-danube-3-4b")
#: the first layers served on the card and by a device="cpu" engine
DENSE_DEPTH = 2
#: the embeds archs: B rows, a prefill of S positions, then N decode steps
DENSE_EMBEDS = (2, 64, 8)
# the embeds archs' decode steps against the forward over the whole
# sequence.  The reference's atol for this check
# (tests/models/test_decode_equivalence.py) is 2e-3, on fp32 logits of a
# 2-layer model; at bf16 and full depth the decode step and the forward
# round the hidden state at other points, as TOL_LM sets out for
# serve_lm's 26 layers, so this check takes TOL_LM too
TOL_EMBEDS = TOL_LM


def phase_serve_dense(ctx):
    """The reference's six dense decoders at full width (DENSE_RUNS), one
    on the card at a time: the token archs through serving.ServingEngine
    (_dense_serve), the embeds archs through transformer.prefill /
    decode_step (_dense_embeds)."""
    import gc

    import torch

    from repro_torch import rnn
    from repro_torch.models import transformer as tf

    dev = rnn.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx["serve_dense"] = {}
    for arch, layers, why in DENSE_RUNS:
        cfg = _dense_config(arch, layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(cfg,
                                torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        cut = (f"depth cut {_dense_config(arch).n_layers} -> {cfg.n_layers}: "
               f"{why}" if layers else "whole (full width and depth)")
        print(f"serve_dense: {arch} L={cfg.n_layers} d_model={cfg.d_model} "
              f"heads {cfg.n_heads} on {cfg.n_kv_heads} kv of {cfg.head_dim} "
              f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} window={cfg.window} "
              f"{cfg.dtype}: {n_params:,} parameters "
              f"({2 * n_params / 1e9:.1f} GB) drawn on the card in "
              f"{init_s:.2f} s; {cut}")
        t0 = time.perf_counter()
        run = (_dense_embeds if cfg.embed_stub else _dense_serve)
        rec = run(ctx, cfg, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"serve_dense: {arch} peak device memory allocated "
              f"{peak / 1e9:.1f} GB of the card's {total / 1e9:.1f} GB "
              f"(weights {2 * n_params / 1e9:.1f} GB)")
        rec.update(layers=cfg.n_layers, params=n_params, cut=cut,
                   wall_s=time.perf_counter() - t0, card=ctx.get("card"),
                   peak_gb=peak / 1e9)
        ctx["serve_dense"][arch] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _dense_serve(ctx, cfg, params):
    """A token arch through ServingEngine(max_batch=4): DENSE_PROMPTS (and
    DENSE_LONG first for a windowed arch), DENSE_NEW new tokens each,
    held to serve_lm's checks (_serve_checks) with every decode step at
    6 L mvm and L decode_attention launches and no prefill launching
    either; a windowed arch's first-wave ticks on a wrapped ring; for
    DENSE_F3 each attention layer of the decode step against the forward
    (_f3_layers); the first DENSE_DEPTH layers on the card against a
    device="cpu" engine.  One replayed tick runs under the profiler for
    the device's busy share (_tick_stats)."""
    label = f"serve_dense {cfg.name}"
    L = cfg.n_layers
    lengths = ((DENSE_LONG,) if cfg.window else ()) + DENSE_PROMPTS
    max_seq = _dense_max_seq(cfg)
    prompts = _lm_prompts(cfg.vocab_size, lengths, seed=12)
    per_step = (6 * L, L, 0)
    wrapped = []

    def watch(kind, n, graph, tokens):
        if kind == "decode" and n == 4 and cfg.window:
            # the long prompt, served first, holds slot 0 for the first
            # wave's DENSE_NEW - 1 ticks
            wrapped.append(int(graph.cache["idx"][0]) >= cfg.window)

    eng, done, _, steps, err, serve_s = _serve_checks(
        ctx, label, cfg, params, prompts, DENSE_NEW, max_seq, per_step,
        (0, 0, 0), watch)
    if cfg.window:
        first = wrapped[:DENSE_NEW - 1]
        print(f"{label}: the first wave's {len(first)} batched ticks ran "
              f"with the {DENSE_LONG}-token request's {cfg.window}-slot ring "
              f"wrapped in slot 0: {sum(first)} of {len(first)}")
        check(len(first) == DENSE_NEW - 1 and all(first),
              f"{label}: a batched tick of the first wave ran without the "
              "long prompt's wrapped ring")
    rec = {"err": err, "prompts": list(lengths),
           "ticks": sum(n == 4 for n, *_ in steps),
           "remainder_steps": sum(n == 1 for n, *_ in steps),
           "replays": [eng.tick_graph.replays, eng.single_graph.replays]}
    if cfg.name in DENSE_F3:
        rec["layer_share"] = _f3_layers(label, cfg, params, prompts, done,
                                        max_seq)
    rec["depth_err"] = _depth_vs_cpu(cfg, params, DENSE_DEPTH, label)
    _tick_stats(ctx, label, rec, eng, steps, per_step, serve_s,
                lengths, DENSE_NEW)
    del eng
    return rec


def _tick_stats(ctx, label, rec, eng, steps, per_step, serve_s, lengths,
                new):
    """The replayed ticks' medians (B=4 and the batch-1 steps: host wall
    and device span) from ``steps`` (_serve_checks'), and one more B=4
    replay under the profiler (_profiled_replay, ``per_step`` launches):
    the device's busy share of the median span; into ``rec``, printed."""
    import statistics as stats

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan

    # the caching allocator's free blocks back to the card first: CUPTI
    # takes device memory for its activity buffers, and drops kernel
    # records it cannot place (arctic's 55 GB of weights)
    _free()
    busy_ms, kernel_ms = _profiled_replay(
        eng.tick_graph, 4, (mvm, decode_attention, rglru_scan), per_step,
        label)
    for B in (4, 1):
        rows = [(w, d) for n, w, d, r in steps if n == B and r]
        wall = stats.median(w for w, _ in rows)
        span = stats.median(d for _, d in rows)
        rec[f"B{B}"] = dict(replays=len(rows), wall_ms=wall, device_ms=span)
        if B == 4:
            rec["busy"] = busy_ms / span
            rec["tick_kernel_ms"] = dict(zip(("mvm", "decode_attention"),
                                             kernel_ms[:2]))
    print(f"{label}: wall {serve_s:.2f} s for {len(lengths)} requests "
          f"({sum(lengths)} prompt + {len(lengths) * new} generated "
          f"tokens); replayed batched tick (B=4) median host wall "
          f"{rec['B4']['wall_ms']:.3f} ms, device span "
          f"{rec['B4']['device_ms']:.3f} ms over {rec['B4']['replays']} "
          f"replays; device busy {busy_ms:.3f} ms = "
          f"{100 * rec['busy']:.1f}% of the median span (mvm "
          f"{kernel_ms[0]:.3f} ms, decode_attention {kernel_ms[1]:.3f} ms); "
          f"batch-1 step median {rec['B1']['wall_ms']:.3f} ms wall, "
          f"{rec['B1']['device_ms']:.3f} ms span; card {ctx.get('card')}")


def _dense_embeds(ctx, cfg, params):
    """An embeds arch through transformer.prefill on seeded embeddings
    (B rows of S positions; qwen2-vl's with three distinct (t, h, w)
    position streams, an 8-wide patch grid at t = 0), then N decode_steps,
    held against one forward over the whole sequence (TOL_EMBEDS; greedy
    argmax where the top-2 margin exceeds it): every decode step 6 L mvm
    and L decode_attention launches, the prefill none, no plain version
    on the card.  For M-RoPE the prefill's logits must also move when the
    streams are made equal (the sections are used)."""
    import statistics as stats

    import torch

    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.models import transformer as tf

    label = f"serve_dense {cfg.name}"
    B, S, N = DENSE_EMBEDS
    L = cfg.n_layers
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    embeds = torch.randn((B, S + N, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    pre = {"embeds": embeds[:, :S]}
    full_pos = None
    if cfg.mrope_sections:
        i = torch.arange(S, device=dev)
        pos3 = torch.stack([torch.zeros_like(i), i // 8, i % 8])
        pos3 = pos3[:, None].expand(3, B, S).to(torch.int32)
        tail = torch.arange(S, S + N, dtype=torch.int32,
                            device=dev)[None, None].expand(3, B, N)
        pre["positions"] = pos3
        full_pos = torch.cat([pos3, tail], dim=-1)
    everything = entries()
    lm = (mvm, decode_attention, rglru_scan)
    reset_counts(*everything)
    walls = []
    with torch.inference_mode():
        lg, cache = tf.prefill(cfg, params, pre, seq_len=S + N)
        torch.cuda.synchronize()
        pre_launches = tuple(f.kernel_launches for f in lm)
        outs, per = [lg], []
        for t in range(S, S + N):
            before = [f.kernel_launches for f in lm]
            t0 = time.perf_counter()
            lg, cache = tf.decode_step(cfg, params, cache,
                                       {"embeds": embeds[:, t:t + 1]})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            per.append(tuple(f.kernel_launches - b
                             for f, b in zip(lm, before)))
            outs.append(lg)
        others = sum(f.calls for f in everything if f not in lm)
        check(pre_launches == (0, 0, 0) and all(
            p == (6 * L, L, 0) for p in per),
            f"{label}: the prefill launched {pre_launches} or a decode step "
            f"did not launch {6 * L} mvm and {L} decode_attention: "
            f"{sorted(set(per))}")
        check(all(f.calls == f.kernel_launches for f in lm) and others == 0,
              f"{label}: an entry point ran its plain version on the card, "
              "or another family's kernel was called")
        tally(ctx, *lm)
        inc = torch.cat(outs, dim=1)
        full, _, _ = tf.forward(cfg, params, embeds=embeds,
                                positions=full_pos)
        moved = None
        if cfg.mrope_sections:
            text, _, _ = tf.forward(cfg, params, embeds=embeds[:, :S])
            moved = float((text - full[:, :S]).abs().max())
        torch.cuda.synchronize()
    err = float((inc - full).abs().max())
    dec = full[:, S:].reshape(-1, full.shape[-1])
    margin = _margin(dec)
    sure = (margin > TOL_EMBEDS).cpu()
    agree = (inc[:, S:].argmax(-1) == full[:, S:].argmax(-1)).reshape(-1).cpu()
    print(f"{label}: prefill of {S} positions x {B} rows on seeded embeds"
          + (" with three distinct (t, h, w) position streams" if full_pos
             is not None else "")
          + f", then {N} decode steps (mvm {6 * L}, decode_attention {L} "
          f"launches each; eager, median {stats.median(walls):.3f} ms host "
          f"wall a step): logits vs the forward over the whole sequence "
          f"max_abs_err {err:.3e} (tol {TOL_EMBEDS:g}; |logit| <= "
          f"{float(full.abs().max()):.2f}); decoded argmax equal at "
          f"{int(agree.sum())}/{len(agree)}, smallest top-2 margin "
          f"{float(margin.min()):.3e}"
          + (f"; the prefill's logits move by {moved:.3e} when the three "
             f"streams are made equal" if moved is not None else ""))
    check(bool(torch.isfinite(inc).all()), f"{label}: non-finite logits")
    check(err <= TOL_EMBEDS, f"{label}: the decode steps disagree with the "
                             f"forward: {err:.3e} > {TOL_EMBEDS:g}")
    check(bool(agree[sure].all()), f"{label}: a decoded argmax differs where "
                                   f"the top-2 margin exceeds {TOL_EMBEDS:g}")
    if moved is not None:
        check(moved > TOL_EMBEDS, f"{label}: M-RoPE's streams change nothing "
                                  f"({moved:.3e})")
    return {"err": err, "decode_ms": stats.median(walls), "rows": B,
            "prefill": S, "steps": N, "mrope_moved": moved}


#: serve_moe: the drop-free run's capacity factor, the reference's own
#: for its decode-equivalence check (tests/models/test_decode_equivalence.py);
#: prefill capacities are then T, so every request's logits can be held
#: against a teacher-forced forward
MOE_DROP_FREE = 64.0
#: serve_moe: the first layers served on the card and by a device="cpu"
#: engine, by arch (arctic's 2 layers are 54.4 GB of bf16 weights: the
#: CPU engine would upcast 17.8 GB expert leaves to fp32 for every step
#: on the chip machine's host; olmoe runs the same MoE code)
MOE_DEPTH = {"olmoe-1b-7b": 2}
# serve_moe: a router probability moves under rounding by about the
# relative error of the router logits, which the bf16 hidden state (the
# decode step and the forward round it at other points) carries to a few
# percent at depth; so the engine may pick an expert the forward ranks
# just below its k-th, within 10% of that probability, and no further: a
# wrong expert is one ranked far below.  Its two readings on an H100:
# olmoe's sound runs pick within 7.9e-2 (388 of 8,160 routed pairs
# differ), arctic's within 1.9e-3; the planted wrong expert of
# _moe_flips, which must fail it, lands at ~0.99
FLIP_GAP = 0.1
#: serve_xlstm: prompts whose buckets (4, 32, 128; 256, 2048) take the
#: recurrent mLSTM prefill and then the chunkwise one
XLSTM_PROMPTS = (5, 37, 140, 300, 2100)
XLSTM_MAX_SEQ = 2112
#: serve_xlstm: the requests whose decode step also runs layer by layer on
#: the CPU (_xlstm_layers_vs_forward)
XLSTM_CPU_UIDS = (0, 1)


def _load_model(ctx, label, arch, layers, why):
    """Draw ``arch``'s bf16 weights (cut to ``layers``) on the card from a
    seeded generator, print its size and cut; returns (cfg, params, cut)
    with the peak-memory counter reset before the draw."""
    import torch

    from repro_torch import rnn
    from repro_torch.models import transformer as tf

    dev = rnn.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _dense_config(arch, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    cut = (f"depth cut {_dense_config(arch).n_layers} -> {cfg.n_layers}: "
           f"{why}" if layers else "whole (full width and depth)")
    extra = (f" {cfg.n_experts} experts top-{cfg.experts_per_token} "
             f"(d_ff {cfg.d_ff}, dense branch {cfg.moe_dense_ff}, capacity "
             f"factor {cfg.capacity_factor})" if cfg.n_experts else
             f" blocks {cfg.block_pattern}")
    print(f"{label}: {arch} L={cfg.n_layers} d_model={cfg.d_model} heads "
          f"{cfg.n_heads} on {cfg.n_kv_heads} kv of {cfg.head_dim}{extra} "
          f"vocab={cfg.vocab_size} {cfg.dtype}: {n_params:,} parameters "
          f"({2 * n_params / 1e9:.1f} GB) drawn on the card in "
          f"{init_s:.2f} s; {cut}")
    return cfg, params, dict(params=n_params, cut=cut, layers=cfg.n_layers,
                             init_s=init_s)


def _peak(ctx, label, rec, t0):
    import torch

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{label}: peak device memory allocated {peak / 1e9:.1f} GB of "
          f"the card's {total / 1e9:.1f} GB (weights "
          f"{2 * rec['params'] / 1e9:.1f} GB)")
    rec.update(peak_gb=peak / 1e9, wall_s=time.perf_counter() - t0,
               card=ctx.get("card"))


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


class _RouteLog:
    """The experts a serving run routes each token to, by request,
    position and layer: a prefill's as its route calls return them; a
    decode step's from the eager first step at its batch size, or, for a
    replay, read back from the buffers its capture's route calls wrote
    (held here, so nothing else is allocated in them, and each replay
    overwrites them in place).  ``recorder`` makes, for _route_as, the
    route that records; ``watch`` and ``on_engine`` plug into
    _serve_checks.  ``pinned(uid)`` is a route that takes, layer by
    layer, the experts the engine took at each of that request's
    positions (their weights from the forward's own probabilities), for a
    teacher-forced forward that routes as serving did; given a list, it
    also records there where that forward's own top-k set, which it does
    not use, differs from the engine's."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.table = {}  # uid -> layer -> position -> experts (k,)
        self.eager, self.captured = [], {}
        self.capturing = None
        self.current = []  # the uid being prefilled
        self.eng = None

    def recorder(self, route):
        def record(logits, k, capacity, n_experts):
            import torch

            out = route(logits, k, capacity, n_experts)
            if torch.cuda.is_current_stream_capturing():
                self.captured.setdefault(self.capturing, []).append(out[0])
            else:
                self.eager.append(out[0])
            return out

        return record

    def on_engine(self, eng):
        self.eng = eng
        admit = eng._prefill_admitted

        def tracked(pairs):
            for slot, req in pairs:
                self.current[:] = [req.uid]
                admit([(slot, req)])
            self.current.clear()

        eng._prefill_admitted = tracked

    def watch(self, kind, n, graph, tokens):
        if kind == "prefill":
            rows = [(self.current[0], p) for p in range(n)]
        elif n == 1:
            rows = [(self.current[0], int(graph.cache["idx"][0]))]
        else:
            rows = [(None if r is None else r.uid, int(graph.cache["idx"][i]))
                    for i, r in enumerate(self.eng.slots)]
        self.capturing = id(graph)
        start = len(self.eager)
        L = self.cfg.n_layers

        def after():
            outs = self.eager[start:] or self.captured[id(graph)]
            check(len(outs) == L, f"_RouteLog: {len(outs)} routed layers "
                                  f"for {L}")
            for layer, e in enumerate(outs):
                e = e.cpu()
                for i, (uid, pos) in enumerate(rows):
                    if uid is not None:
                        self.table.setdefault(uid, {}).setdefault(
                            layer, {})[pos] = e[i].clone()
            del self.eager[start:]

        return after

    def experts(self, uid, layer, S, device):
        rows = self.table[uid][layer]
        check(sorted(rows) == list(range(S)), f"_RouteLog: request {uid} "
              f"layer {layer} routed positions {sorted(rows)[:3]}... of {S}")
        import torch

        return torch.stack([rows[p] for p in range(S)]).to(device)

    def pinned(self, uid, found=None, plant=None):
        """The pinned route; ``found``, if a list, gets (layer, position,
        relative gap) wherever the forward's own top-k set differs from
        the engine's: the gap is the forward's own k-th probability less
        its probability of the engine's least likely pick, over the
        former.  With ``plant`` (a layer) that layer sends each token's
        heaviest pick to the expert its router ranks last, at the
        heaviest pick's weight: a wrong expert, for the controls
        (_moe_flips)."""
        import torch

        from repro_torch.models.layers import moe

        layer = [0]

        def route(logits, k, capacity, n_experts):
            top_e = self.experts(uid, layer[0], logits.shape[0],
                                 logits.device)
            probs = torch.softmax(logits, dim=-1)
            top_w = probs.gather(1, top_e)
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                            1e-9)
            if layer[0] == plant:
                heavy = top_w.argmax(-1, keepdim=True)
                top_e = top_e.scatter(1, heavy, probs.argmin(-1,
                                                             keepdim=True))
            if found is not None:
                own_w, own_e = moe._top_k(probs, k)
                differ = (torch.sort(own_e, dim=-1).values
                          != torch.sort(top_e, dim=-1).values).any(-1)
                least = probs.gather(1, top_e).min(-1).values
                gap = (own_w[:, -1] - least) / own_w[:, -1]
                for pos in differ.nonzero()[:, 0].tolist():
                    found.append((layer[0], pos, float(gap[pos])))
            layer[0] += 1
            slot, valid = moe.assign_slots(top_e, capacity, n_experts)
            return top_e, slot, top_w, valid

        return route


def phase_serve_moe(ctx):
    """The MoE decoders at full width (MOE_RUNS), one on the card at a
    time, through serving.ServingEngine(max_batch=4) (_moe_serve)."""
    ctx["serve_moe"] = {}
    for arch, layers, why in MOE_RUNS:
        label = f"serve_moe {arch}"
        t0 = time.perf_counter()
        cfg, params, rec = _load_model(ctx, label, arch, layers, why)
        rec.update(_moe_serve(ctx, label, cfg, params))
        _peak(ctx, label, rec, t0)
        ctx["serve_moe"][arch] = rec
        del params
        _free()


def _moe_serve(ctx, label, cfg, params):
    """A MoE arch through ServingEngine(max_batch=4): DENSE_PROMPTS,
    DENSE_NEW new tokens each, twice.  First drop-free (capacity factor
    MOE_DROP_FREE), held to serve_lm's checks (_serve_checks): every
    decode step 3 L mvm (attention) plus 3 L with arctic's dense branch
    and L decode_attention launches, every later step a replay, no plain
    version, each request's logits within TOL_MOE (TOL_LM where the arch
    has none) of a teacher-forced forward at the same factor that routes
    as served (_RouteLog), and the near-tie routing flips and a planted
    wrong expert against it (_moe_flips); the first MOE_DEPTH layers
    against a device="cpu" engine; the replayed tick's medians and busy
    share (_tick_stats).  Then at the config's own capacity factor, as
    users run it (_moe_routing): the routing invariants held on the card
    for every routed call, and each prefill's dropped picks printed."""
    import dataclasses

    L = cfg.n_layers
    per_layer = 6 if cfg.moe_dense_ff else 3
    per_step = (per_layer * L, L, 0)
    prompts = _lm_prompts(cfg.vocab_size, DENSE_PROMPTS, seed=12)
    free = dataclasses.replace(cfg, capacity_factor=MOE_DROP_FREE)
    tol = TOL_MOE.get(cfg.name, TOL_LM)
    log = _RouteLog(free)

    def pinned_forward(uid, prompt, completion):
        with _route_as(lambda _: log.pinned(uid)):
            return _teacher_forced(free, params, prompt, completion)

    with _route_as(log.recorder):
        eng, done, logits, steps, err, serve_s = _serve_checks(
            ctx, f"{label} (capacity factor {MOE_DROP_FREE:g}, the "
            f"forward routed as served)", free, params, prompts, DENSE_NEW,
            DENSE_MAX_SEQ, per_step, (0, 0, 0), watch=log.watch,
            on_engine=log.on_engine, reference=pinned_forward, tol=tol)
    rec = {"err": err, "tol": tol, "prompts": list(DENSE_PROMPTS),
           "ticks": sum(n == 4 for n, *_ in steps),
           "remainder_steps": sum(n == 1 for n, *_ in steps),
           "replays": [eng.tick_graph.replays, eng.single_graph.replays],
           "per_step": list(per_step)}
    rec.update(_moe_flips(label, free, params, prompts, done, logits, log,
                          tol))
    depth = MOE_DEPTH.get(cfg.name)
    if depth:
        rec["depth_err"] = _depth_vs_cpu(free, params, depth, label)
    else:
        print(f"{label}: no device=\"cpu\" depth check: its "
              f"{L} layers are the whole cut model, "
              f"{2 * sum(t.numel() for t in _leaves(params)) / 1e9:.1f} GB "
              f"of bf16 weights, which the CPU engine would upcast to fp32 "
              f"leaf by leaf at every step (MOE_DEPTH)")
    _tick_stats(ctx, label, rec, eng, steps, per_step, serve_s,
                DENSE_PROMPTS, DENSE_NEW)
    del eng
    _free()
    rec["routing"] = _moe_routing(ctx, label, cfg, params, prompts, done)
    return rec


def _moe_flips(label, cfg, params, prompts, done, logits, log, tol):
    """Why the drop-free run's logits are held against a forward that
    routes as serving did: in bf16 the decode step and the forward round
    the hidden state at other points, so a token whose router
    probabilities nearly tie at the k-th place may pick another expert on
    the two paths — a change of one of its top-k experts, which then
    moves every later layer.  Here the forward routed as served records
    where its own top-k set (unused) differs from the engine's: each such
    difference must be a near-tie, within FLIP_GAP of the k-th
    probability.  The forward routing on its own is held to nothing; its
    largest logit difference from the pinned one is printed.  Then the
    control that both limits must see: the pinned forward of the first
    request with a wrong expert planted at layer L // 2 (_RouteLog.pinned
    ``plant``) must differ from the served logits by more than ``tol``,
    and its flips must reach past FLIP_GAP."""
    err, found = 0.0, []
    for uid, c in sorted(done.items()):
        flips = []
        with _route_as(lambda _: log.pinned(uid, flips)):
            pinned = _teacher_forced(cfg, params, prompts[uid], c)
        err = max(err, float((_teacher_forced(cfg, params, prompts[uid], c)
                              - pinned).abs().max()))
        found += [(uid,) + f for f in flips]
    routed = sum(len(pos) for t in log.table.values() for pos in t.values())
    worst = max((g for *_, g in found), default=0.0)
    print(f"{label}: in the forward routed as served, its own top-k set "
          f"would differ from the engine's at {len(found)} of {routed} "
          f"routed (position, layer) pairs, largest relative gap between "
          f"its k-th probability and its probability of the engine's pick "
          f"{worst:.3e} (FLIP_GAP {FLIP_GAP:g}); the forward routing on "
          f"its own departs from it by {err:.3e} in the logits")
    check(worst <= FLIP_GAP, f"{label}: the engine picked an expert "
          f"{worst:.3e} below the forward's k-th probability (FLIP_GAP "
          f"{FLIP_GAP:g}): more than rounding moves a router probability")
    layer, planted = cfg.n_layers // 2, []
    with _route_as(lambda _: log.pinned(0, planted, plant=layer)):
        ref = _teacher_forced(cfg, params, prompts[0], done[0])
    planted_err = float((logits[0] - ref).abs().max())
    planted_gap = max((g for *_, g in planted), default=0.0)
    print(f"{label}: control, request 0 against its forward with a wrong "
          f"expert planted at layer {layer} (each token's heaviest pick sent "
          f"to the expert its router ranks last): logits max_abs_err "
          f"{planted_err:.3e} (tol {tol:g}, margin {planted_err / tol:.2f}x)"
          f", largest relative gap {planted_gap:.3e} (FLIP_GAP "
          f"{FLIP_GAP:g}, margin {planted_gap / FLIP_GAP:.2f}x)")
    check(planted_err > tol, f"{label}: the logit limit {tol:g} does not "
          f"see a wrong expert at layer {layer}: {planted_err:.3e}")
    check(planted_gap > FLIP_GAP, f"{label}: FLIP_GAP does not see a "
          f"wrong expert at layer {layer}: {planted_gap:.3e}")
    return {"unpinned_err": err, "flips": len(found), "routed": routed,
            "flip_gap": worst, "planted_err": planted_err,
            "planted_gap": planted_gap}


def _moe_routing(ctx, label, cfg, params, prompts, free_done):
    """The same prompts served at the config's capacity factor, with
    every route call that runs eagerly (each prefill, the first step at
    each batch size; a graph capture's is skipped) recorded and held on
    the card: k distinct experts a token; each (expert, slot) held by at
    most one valid pick, every valid slot below the capacity; each
    expert's load min(its demand, C); the valid picks' combine weights
    summing to <= 1 a token, and to 1 (within 1e-6) where none was
    dropped.  Each prefill's dropped (token, choice) picks are printed;
    the run's launches are tallied; the greedy tokens are compared with
    the drop-free run's."""
    import torch

    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mvm_tile.ops import mvm
    from repro_torch.kernels.rglru.ops import rglru_scan

    k, E = cfg.experts_per_token, cfg.n_experts
    seen, where = [], []

    def recorder(route):
        def record(logits, k_, capacity, n_experts):
            out = route(logits, k_, capacity, n_experts)
            if not torch.cuda.is_current_stream_capturing():
                seen.append((where[-1] if where else "decode", capacity)
                            + tuple(t.clone() for t in out))
            return out

        return record

    def hook(kind, n, fn, graph=None, tokens=None):
        where.append(f"prefill {n}" if kind == "prefill" else "decode")
        try:
            return fn()
        finally:
            where.pop()

    lm = (mvm, decode_attention, rglru_scan)
    reset_counts(*entries())
    with _route_as(recorder):
        _, done, logits = _lm_serve(cfg, params, prompts, DENSE_NEW, "cuda",
                                    max_seq=DENSE_MAX_SEQ, hook=hook)
    torch.cuda.synchronize()
    tally(ctx, *lm)
    check(sorted(done) == list(range(len(prompts)))
          and all(len(c.tokens) == DENSE_NEW for c in done.values()),
          f"{label}: a request did not complete at capacity factor "
          f"{cfg.capacity_factor:g}")
    check(all(bool(torch.isfinite(x).all()) for x in logits.values()),
          f"{label}: non-finite logits at capacity factor "
          f"{cfg.capacity_factor:g}")
    drops = []
    for name, C, e, s, w, v in seen:
        T = e.shape[0]
        key = (e * C + s)[v]
        demand = torch.zeros(E, dtype=torch.int64, device=e.device
                             ).index_add_(0, e.reshape(-1),
                                          torch.ones_like(e.reshape(-1)))
        load = torch.zeros(E, dtype=torch.int64, device=e.device
                           ).index_add_(0, e[v], torch.ones_like(e[v]))
        wsum = (w * v).sum(-1)
        full = v.all(-1)
        ok = (bool((torch.sort(e, dim=-1).values.diff(dim=-1) > 0).all())
              and torch.unique(key).numel() == key.numel()
              and bool((s[v] < C).all())
              and torch.equal(load, torch.clamp_max(demand, C))
              and bool((wsum <= 1 + 1e-6).all())
              and bool(((wsum[full] - 1).abs() <= 1e-6).all()))
        check(ok, f"{label}: a routing invariant fails at capacity factor "
                  f"{cfg.capacity_factor:g} ({name}, T={T}, C={C})")
        if name.startswith("prefill"):
            drops.append((name.split()[1], C, int((~v).sum()), T * k))
    check(len(drops) == len(prompts) * cfg.n_layers,
          f"{label}: {len(drops)} routed prefill layers recorded for "
          f"{len(prompts)} prefills of {cfg.n_layers} layers")
    by_bucket = {}
    for bucket, C, n, picks in drops:
        by_bucket.setdefault((bucket, C, picks), []).append(n)
    same = sum(done[u].tokens == free_done[u].tokens for u in done)
    print(f"{label} (capacity factor {cfg.capacity_factor:g}): "
          f"{len(done)} requests; routing invariants held on the card for "
          f"{len(seen)} routed calls (each prefill's layers and the eager "
          f"first step at each batch size); dropped (token, choice) picks "
          f"by prefill bucket (capacity C of T x k picks), one count a "
          f"layer: "
          + "; ".join(f"T={b} C={C}: {ns} of {picks}"
                      for (b, C, picks), ns in by_bucket.items())
          + f"; {same} of {len(done)} requests' greedy tokens equal the "
          f"drop-free run's")
    return {"calls": len(seen), "drops": {f"T={b} C={C}": ns
                                      for (b, C, _), ns in by_bucket.items()},
            "same_tokens": same}


def phase_serve_xlstm(ctx):
    """xlstm-125m whole at full width through
    serving.ServingEngine(max_batch=4), twice (_xlstm_serve): with the
    weights as the reference's init draws them, and with every sLSTM R
    scaled to the fan-in of the head it multiplies (_contract_slstm)."""
    arch, layers, why = XLSTM_RUN
    label = f"serve_xlstm {arch}"
    t0 = time.perf_counter()
    cfg, params, rec = _load_model(ctx, label, arch, layers, why)
    rec.update(_xlstm_serve(ctx, label, cfg, params))
    _peak(ctx, label, rec, t0)
    ctx["serve_xlstm"] = rec
    del params
    _free()


def _contract_slstm(cfg, params):
    """Scale every sLSTM layer's recurrent R (H, dh, 4 dh) in place by
    sqrt(H / dh): from the reference's draw at 1/sqrt(H) (dense_init takes
    its fan-in from the leading axis, the heads) to 1/sqrt(dh), the fan-in
    of the head state it multiplies."""
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    for kind, p in zip(cfg.layer_kinds(), params["layers"]):
        if kind == "slstm":
            p["slstm"]["R"].mul_((H / dh) ** 0.5)


def _xlstm_serve(ctx, label, cfg, params):
    """XLSTM_PROMPTS (buckets 4, 32, 128 through the recurrent mLSTM
    prefill, 256 and 2048 through the chunkwise one), DENSE_NEW new tokens
    each, served twice under serve_lm's checks (_serve_checks): every
    decode step 48 mvm launches (6 for each of the 6 mLSTM layers, 2 for
    each of the 6 sLSTM layers) and no decode_attention, every later step
    a replay, no plain version.  First with the reference's init: sLSTM's
    R drawn at 1/sqrt(H) makes the recurrence chaotic, so that one bf16
    ulp of rounding grows along the sequence to the logits' own size
    (_xlstm_horizon, printed): no end-to-end comparison of two
    computations that round differently holds there, and the logits are
    printed, not held; each layer's decode step is held against the
    forward's one step at a time (_xlstm_layers_vs_forward); the replayed
    tick's medians and busy share (_tick_stats).  Then with R at 1/sqrt(dh)
    (_contract_slstm; every shape, kernel and code path the same), where
    rounding stays at a tenth of the logits' size and does not grow along
    the sequence (_xlstm_horizon, and the fp32 forward, _xlstm_fp32):
    each request's logits within TOL_XLSTM of the teacher-forced forward,
    the first DENSE_DEPTH layers against a device="cpu" engine, and two
    planted faults that this check must see (_xlstm_planted)."""
    n_mvm = len(_step_mvm_shapes(cfg))
    check(n_mvm == 48, f"{label}: {n_mvm} mvm a step, not 48")
    per_step = (n_mvm, 0, 0)
    prompts = _lm_prompts(cfg.vocab_size, XLSTM_PROMPTS, seed=14)
    drawn = f"{label} (R at 1/sqrt(H), as drawn)"
    eng, done, _, steps, err, serve_s = _serve_checks(
        ctx, drawn, cfg, params, prompts, DENSE_NEW, XLSTM_MAX_SEQ,
        per_step, (0, 0, 0), tol=None)
    rec = dict(err_as_drawn=err, prompts=list(XLSTM_PROMPTS),
               buckets=sorted(eng.prefill_lengths),
               ticks=sum(n == 4 for n, *_ in steps),
               remainder_steps=sum(n == 1 for n, *_ in steps),
               replays=[eng.tick_graph.replays, eng.single_graph.replays])
    rec["spread_as_drawn"] = _xlstm_horizon(drawn, cfg, params, prompts,
                                            done)
    rec["layer_share"], rec["cpu_share"] = _xlstm_layers_vs_forward(
        drawn, cfg, params, prompts, done)
    _tick_stats(ctx, label, rec, eng, steps, per_step, serve_s,
                XLSTM_PROMPTS, DENSE_NEW)
    del eng
    _free()

    _contract_slstm(cfg, params)
    tamed = f"{label} (R at 1/sqrt(dh))"
    _, done, logits, _, rec["err"], _ = _serve_checks(
        ctx, tamed, cfg, params, prompts, DENSE_NEW, XLSTM_MAX_SEQ,
        per_step, (0, 0, 0), tol=TOL_XLSTM)
    rec["fp32"] = _xlstm_fp32(tamed, cfg, params, prompts, done, logits)
    rec["spread"] = _xlstm_horizon(tamed, cfg, params, prompts, done)
    rec["depth_err"] = _depth_vs_cpu(cfg, params, DENSE_DEPTH, tamed)
    rec["planted"] = _xlstm_planted(tamed, cfg, params, prompts)
    return rec


def _xlstm_fp32(label, cfg, params, prompts, done, logits):
    """The size of bf16 rounding in this model: the teacher-forced forward
    of the same weights cast up to fp32 against the bf16 forward and
    against the served logits, by request.  Printed; returns the largest
    of each."""
    import dataclasses

    import torch

    def up(tree):
        if isinstance(tree, dict):
            return {k: up(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(up(v) for v in tree)
        return tree.float() if tree.is_floating_point() else tree

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = up(params)
    fwd, served = [], []
    for uid, c in sorted(done.items()):
        ref = _teacher_forced(cfg32, p32, prompts[uid], c)
        fwd.append(float((_teacher_forced(cfg, params, prompts[uid], c)
                          - ref).abs().max()))
        served.append(float((logits[uid] - ref).abs().max()))
    del p32
    torch.cuda.empty_cache()
    print(f"{label}: against the fp32 forward of the same weights, the "
          f"bf16 forward's logits differ by "
          + ", ".join(f"{v:.3e}" for v in fwd) + " and the served ones by "
          + ", ".join(f"{v:.3e}" for v in served) + " (by request)")
    return {"forward": max(fwd), "served": max(served)}


def _xlstm_horizon(label, cfg, params, prompts, done):
    """How far the teacher-forced forward's logits move, at each request's
    compared positions, when its input embeddings move by about one bf16
    ulp (_teacher_forced's ``nudge``): the size rounding alone gives the
    difference of two computations that round at other points.  Printed;
    returns the largest by request."""
    spread = []
    for uid, c in sorted(done.items()):
        ref = _teacher_forced(cfg, params, prompts[uid], c)
        nudged = _teacher_forced(cfg, params, prompts[uid], c, nudge=True)
        spread.append(float((nudged - ref).abs().max()))
    print(f"{label}: the forward with its input embeddings moved by about "
          f"one bf16 ulp: logits move by "
          + ", ".join(f"{v:.3e}" for v in spread)
          + " at the compared positions (by request; prompts "
          + ", ".join(str(len(p)) for p in prompts) + ")")
    return spread


def _xlstm_planted(label, cfg, params, prompts):
    """The end-to-end check must see a wrong served path: two requests
    (37 and 140 prompt tokens, DENSE_NEW new) are served once with each
    of two planted faults and held against the teacher-forced forward,
    which runs neither: mvm drops the last 64 of the X rows of every
    decode projection (a lost k-tile), and the engine's splice of a
    prefilled request into its batch slot leaves every mLSTM layer's
    matrix memory C at zero (a state not carried).  Each must give
    logits beyond TOL_XLSTM, or a greedy token that differs from the
    forward's argmax where its top-2 margin exceeds TOL_XLSTM.  Launches
    here are outside the counted run; returns each fault's error."""
    from repro_torch.models.layers import common

    mvm = common.mvm
    mlstm = [i for i, k in enumerate(cfg.layer_kinds()) if k == "mlstm"]

    def lose_memory(eng):
        splice = eng._splice_cache

        def spliced(slot, req_cache):
            splice(slot, req_cache)
            for i in mlstm:
                eng.cache["layers"][i]["C"][slot].zero_()

        eng._splice_cache = spliced

    faults = {"mvm drops the last 64 X rows": (
                  lambda x, W: mvm(x[:, :-64].contiguous(), W[:-64]), None),
              "the splice leaves the mLSTM memory C at zero": (
                  mvm, lose_memory)}
    chosen = [prompts[XLSTM_PROMPTS.index(n)] for n in (37, 140)]
    out = {}
    for name, (planted, on_engine) in faults.items():
        common.mvm = planted
        try:
            _, done, logits = _lm_serve(cfg, params, chosen, DENSE_NEW,
                                        "cuda", max_seq=XLSTM_MAX_SEQ,
                                        on_engine=on_engine)
        finally:
            common.mvm = mvm
        err, wrong = _off_the_forward(cfg, params, chosen, done, logits,
                                      TOL_XLSTM)
        print(f"{label}: planted fault, {name}: logits vs the forward "
              f"max_abs_err {err:.3e} (tol {TOL_XLSTM:g}, margin "
              f"{err / TOL_XLSTM:.2f}x); {wrong} tokens differ where the "
              f"top-2 margin exceeds {TOL_XLSTM:g}")
        check(err > TOL_XLSTM or wrong > 0, f"{label}: the logit check "
              f"does not see the planted fault ({name})")
        out[name] = err
    return out


def _xlstm_layers_vs_forward(label, cfg, params, prompts, done):
    """Each xLSTM layer of the decode step against the forward, one step
    at a time on the same input and the same state (as F3 holds the
    attention layers): the forward is run layer by layer
    (``transformer._layer_apply``); at each layer the state the engine's
    prefill leaves at its bucket's end comes from the layer's prefill
    form over the bucket (chunkwise mLSTM, recurrent sLSTM), then at every
    position the engine decoded (the remainder prompt tokens and the
    generated ones) the decode block (``decode=True``: mvm projections)
    and the forward's block (torch.matmul) each take the forward's normed
    input there and the forward-mode state before it; their outputs must
    agree within TOL_LAYER of the position's largest |output|, and the
    walk goes on from the forward-mode state.  For the requests in
    XLSTM_CPU_UIDS the decode block also runs on the CPU (the plain mvm,
    the cells' CPU forms) on copies of the same input and state, within
    TOL_LAYER of the card's: one step, where at the reference's init a
    whole-model comparison of the card and the CPU is past the horizon of
    rounding within a few tokens (_xlstm_horizon).
    Returns the worst shares of TOL_LAYER (decode vs forward, card vs
    CPU), over every request, position and layer."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import xlstm
    from repro_torch.models.layers.common import param_dtype
    from repro_torch.models.layers.embedding import embed
    from repro_torch.models.layers.norm import rms_norm

    dev = torch.device("cuda")
    H, dtype = cfg.n_heads, param_dtype(cfg)
    worst_all, cpu_all = 0.0, 0.0

    def share(out, ref):
        return float((out.float() - ref.float()).abs().max()) / (
            TOL_LAYER * float(ref.float().abs().max()))

    for uid, c in sorted(done.items()):
        seq = list(prompts[uid]) + c.tokens[:-1]
        L = len(prompts[uid])
        b = 1 << (L.bit_length() - 1)
        shares, on_cpu = [], []
        with torch.inference_mode():
            x = embed(params["head"], torch.tensor(seq, device=dev)[None],
                      dtype)
            for i, kind in enumerate(cfg.layer_kinds()):
                p = params["layers"][i]
                h = rms_norm(x, p["norm1"], cfg.norm_eps)
                blk = p[kind]
                st = tf._init_layer_cache(cfg, kind, 1, 0, dtype, dev)
                if kind == "mlstm":
                    apply = xlstm.apply_mlstm
                    _, st = xlstm.apply_mlstm_chunked(blk, h[:, :b], H, st)
                else:
                    apply = xlstm.apply_slstm
                    _, st = xlstm.apply_slstm(blk, h[:, :b], H, st)
                worst, cpu_worst = 0.0, 0.0
                blk_cpu = ({k: v.cpu() for k, v in blk.items()}
                           if uid in XLSTM_CPU_UIDS else None)
                for t in range(b, len(seq)):
                    o_dec, _ = apply(blk, h[:, t:t + 1], H, st, decode=True)
                    if blk_cpu is not None:
                        o_cpu, _ = apply(blk_cpu, h[:, t:t + 1].cpu(), H,
                                         {k: v.cpu() for k, v in st.items()},
                                         decode=True)
                        cpu_worst = max(cpu_worst, share(o_cpu, o_dec.cpu()))
                    o_fwd, st = apply(blk, h[:, t:t + 1], H, st)
                    worst = max(worst, share(o_dec, o_fwd))
                shares.append(worst)
                on_cpu.append(cpu_worst)
                x, _, _ = tf._layer_apply(cfg, kind, p, x, None, None, None,
                                          "train")
        print(f"{label}: request {uid} (prompt {L}, bucket {b}): each "
              f"layer's decode step against the forward's on the same "
              f"input and state at the {len(seq) - b} decoded positions, "
              f"worst over its limit (TOL_LAYER {TOL_LAYER:g} of the "
              f"largest |output|) by layer: "
              + ", ".join(f"{v:.3f}" for v in shares)
              + ("; the same decode step on the CPU against the card's: "
                 + ", ".join(f"{v:.3f}" for v in on_cpu)
                 if uid in XLSTM_CPU_UIDS else ""))
        check(max(shares) <= 1.0, f"{label}: request {uid}: an xLSTM layer "
              f"of the decode step disagrees with the forward's: "
              f"{max(shares):.3f} of TOL_LAYER")
        check(max(on_cpu) <= 1.0, f"{label}: request {uid}: an xLSTM layer "
              f"of the decode step on the CPU disagrees with the card's: "
              f"{max(on_cpu):.3f} of TOL_LAYER")
        worst_all = max(worst_all, max(shares))
        cpu_all = max(cpu_all, max(on_cpu))
    return worst_all, cpu_all


#: train: rglru_scan_bwd's bytes an element (log_a, gx, hs, dhs read;
#: dlog_a, dgx written; fp32)
RGLRU_BWD_BYTES = 24
#: rglru_scan_bwd held against its plain version at these (B, T, W): the
#: train step's shape, B = 4 at T = 2048, and the edges of each strip
#: width's tiles (C = 8: 128 steps a tile at B = 1; C = 16: 64 at B = 2,
#: W = 2560; C = 32: 32 at B = 4) at ragged widths
TRAIN_BWD_CASES = ((1, 1024, 2560), (4, 2048, 2560), (1, 129, 513),
                   (1, 128, 33), (2, 65, 2560), (2, 64, 100), (4, 33, 2560),
                   (4, 31, 513), (3, 1, 70))
#: the full-width step: RecurrentGemma-2B whole, B = 1 at these T (the
#: second only where the first's peak, its part past the params and AdamW
#: state scaled with T, leaves TRAIN_ROOM_GB of the card free),
#: TRAIN_STEPS timed steps each after one warm step; data from the
#: pipeline's "random" source (its markov table would be V x V float64,
#: 524 GB at V = 256,000)
TRAIN_SEQS = (1024, 2048)
TRAIN_STEPS = 3
TRAIN_ROOM_GB = 6.0
#: the 3-layer (rglru, rglru, attn) full-width cut, one step on the card
#: against one on the chip machine's CPU (B = 1, T = TRAIN_CPU_T), AdamW at
#: TRAIN_LR without warmup so that the step moves the bf16 parameters by
#: more than their rounding
TRAIN_CPU_T = 64
TRAIN_LR = 1e-2
# the 3-layer cut, bf16, card against CPU: the loss (mean CE of a
# 256,000-way softmax, ~12.5) within TOL_TRAIN_LOSS; each gradient leaf
# within TOL_TRAIN_GRAD of that leaf's largest |CPU gradient|: the two
# round the bf16 activations and gradients at other points (other
# summation orders, bf16 products summed in fp32 on the card, upcast on
# the CPU), a few bf16 ulps (2^-8 each) of a leaf's scale carried back
# through 3 layers; a lost dlog_a (planted) takes the gate leaves' whole
# gradient.  Each updated parameter within one bf16 ulp of itself plus
# TOL_TRAIN_STEP x lr: AdamW's first step is lr · g / (|g| + eps),
# lr · sign(g) where |g| >> eps, which flips where g is near 0 (2 lr at
# most); and plus TOL_TRAIN_WELL x lr where |g| is larger than twice the
# gradient tolerance of its leaf's largest, so that its sign cannot flip.
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = 2.0 ** -4
TOL_TRAIN_STEP = 2.0
TOL_TRAIN_WELL = 0.05
# every reduced arch, card against CPU (fp32: other summation orders only;
# the loss within TRAIN_RED_LOSS relative, m (0.1 g) within TRAIN_RED_M of
# each leaf's largest; bf16: the 3-layer cut's tolerances)
TRAIN_RED_LOSS = 1e-5
TRAIN_RED_M = 1e-4
#: the FT check: recurrentgemma-2b reduced (fp32), FT_STEPS steps with int8
#: compression, checkpoints every FT_EVERY, a fault at FT_FAULT
FT_STEPS = 12
FT_EVERY = 4
FT_FAULT = 9


def phase_train(ctx):
    """Training (P11) on the card: rglru_scan_bwd against its plain
    version; RecurrentGemma-2B whole at full width through make_train_step;
    a 3-layer full-width cut against the CPU with a planted fault; every
    reduced arch against the CPU; matmul_f32's backward at olmoe's expert
    shape; TrainLoop's exact recovery."""
    import torch

    from repro_torch import rnn

    dev = rnn.resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    _train_bwd_kernel(ctx, dev)
    _train_full(ctx, dev)
    _free()
    _train_cut_vs_cpu(ctx, dev)
    _free()
    _train_matmul_f32(ctx, dev)
    _train_reduced(ctx, dev)
    _train_ft(ctx, dev)
    _free()


def _bwd_case(B, T, W, seed, dev):
    """(log_a, gx, h0, hs, dhs, dhT) of a backward: the forward's inputs
    (_rglru_case), its hs from the kernel, random cotangents."""
    import torch

    from repro_torch.kernels.rglru import ops

    la, gx, h0 = _rglru_case(B, T, W, seed, dev)
    g = torch.Generator().manual_seed(seed + 1)
    dhs = torch.randn((B, T, W), generator=g).to(dev)
    dhT = torch.randn((B, W), generator=g).to(dev)
    hs, _ = ops.rglru_scan_cuda(la, gx, h0)
    return [la, gx, h0, hs, dhs, dhT]


def _rglru_bwd_bound(B, T, W):
    """From the backward's Cost (``rglru_scan_bwd_cost``): 24 bytes an
    element and 12 a channel, ``SCAN_BWD_OPS`` operations an element."""
    from repro_torch.kernels.rglru.ops import rglru_scan_bwd_cost

    seq, state = meta(B, T, W), meta(B, W)
    return cost_bound(rglru_scan_bwd_cost(seq, seq, state, seq, seq,
                                          state))


def _train_bwd_kernel(ctx, dev):
    """rglru_scan_bwd against rglru_scan_bwd_plain at TRAIN_BWD_CASES
    (each output within 1e-6 of its largest |plain|, the same non-finite
    values), bit for bit run to run and each row of a B > 1 call against
    that row's own B = 1 call; then timed at the train step's shape (B = 1,
    T = 1024) in a CUDA graph of RGLRU_GRAPH_LAUNCHES launches and at B =
    4, T = 2048 eager, beside the plain version and the bytes bound."""
    import torch

    from repro_torch.kernels.rglru import ops

    bwd = ops.rglru_scan_bwd
    err_max, same = 0.0, True
    for i, (B, T, W) in enumerate(TRAIN_BWD_CASES):
        args = _bwd_case(B, T, W, seed=200 + i, dev=dev)
        out = bwd(*args)
        ref = ops.rglru_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for o, r in zip(out, ref):
            fin = torch.isfinite(r)
            check(torch.equal(torch.isfinite(o), fin),
                  f"rglru_scan_bwd at B={B} T={T} W={W}: other non-finite "
                  "values than the plain version")
            e = float((o[fin] - r[fin]).abs().max()) if fin.any() else 0.0
            scale = float(r[fin].abs().max()) if fin.any() else 1.0
            errs.append(e / scale)
            err_max = max(err_max, e)
        again = _rglru_same(bwd(*args), out)
        rows = all(_rglru_same(bwd(*(t[b:b + 1] for t in args)),
                               [o[b:b + 1] for o in out])
                   for b in range(B)) if B > 1 else True
        same = same and again and rows
        C, steps = ops.scan_tile(B, W)
        print(f"kernels: rglru_scan_bwd B={B} T={T} W={W} (strips of {C}, "
              f"{steps} steps a tile): max |kernel - plain| / max |plain| "
              f"{max(errs):.2e} (dlog_a, dgx, dh0: "
              f"{', '.join(f'{e:.1e}' for e in errs)}); run to run "
              f"{'bit-equal' if again else 'DIFFERS'}; rows vs B=1 calls "
              f"{'bit-equal' if rows else 'DIFFER'}")
        check(max(errs) <= 1e-6, f"rglru_scan_bwd disagrees with its plain "
                                 f"version at B={B} T={T} W={W}")
    check(same, "rglru_scan_bwd is not bit-equal run to run or across B")

    B, T, W = 1, 1024, 2560
    args = _bwd_case(B, T, W, seed=230, dev=dev)
    n = RGLRU_GRAPH_LAUNCHES
    k_ms = graph_ms(lambda: [bwd(*args) for _ in range(n)]) / n
    eager_ms = median_ms(lambda: bwd(*args), reps=20)
    p_ms = median_ms(lambda: ops.rglru_scan_bwd_plain(*args), reps=1,
                     trials=3)
    b_ms, b_by = _rglru_bwd_bound(B, T, W)
    nbytes = RGLRU_BWD_BYTES * B * T * W
    print(f"kernels: rglru_scan_bwd at B={B} T={T} W={W} (the train step's "
          f"shape; one CUDA graph of {n} launches): kernel {k_ms:.4f} ms a "
          f"launch ({nbytes / k_ms / 1e6:.1f} GB/s, {k_ms / b_ms:.2f}x the "
          f"bound), eager {eager_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); no single PyTorch call computes it")
    ctx["rglru_scan_bwd"] = dict(
        max_abs_err=err_max, ms=k_ms, plain_ms=p_ms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, warm_ms=eager_ms,
        shape=f"B={B} T={T} W={W} fp32 (graph of {n})")
    B, T = 4, 2048
    args = _bwd_case(B, T, W, seed=231, dev=dev)
    w_ms = median_ms(lambda: bwd(*args), reps=20)
    b_ms, b_by = _rglru_bwd_bound(B, T, W)
    print(f"kernels: rglru_scan_bwd at B={B} T={T} W={W} (eager): kernel "
          f"{w_ms:.4f} ms ({RGLRU_BWD_BYTES * B * T * W / w_ms / 1e6:.1f} "
          f"GB/s, {w_ms / b_ms:.2f}x the bound), bound {b_ms:.6f} ms "
          f"({b_by})")
    ctx["rglru_scan_bwd"].update(wide_ms=w_ms, wide_bound_ms=b_ms)


def _train_batch(cfg, B, T, seed, dev):
    """A batch of the synthetic pipeline's "random" source on ``dev``."""
    import torch

    from repro_torch.data import DataConfig, SyntheticPipeline

    data = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B, seed=seed,
        source="random", embed_dim=cfg.d_model if cfg.embed_stub else 0))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(0).items()}


def _train_counts(label, n_rglru):
    """Each train step's launches: one rglru_scan and one rglru_scan_bwd
    a RG-LRU layer, every call a kernel launch (no plain version)."""
    from repro_torch.kernels.rglru import ops

    f, b = ops.rglru_scan, ops.rglru_scan_bwd
    print(f"{label}: rglru_scan {f.kernel_launches} launches ({f.calls} "
          f"calls), rglru_scan_bwd {b.kernel_launches} ({b.calls} calls) for "
          f"{n_rglru} RG-LRU layers")
    check(f.kernel_launches == f.calls == n_rglru
          and b.kernel_launches == b.calls == n_rglru,
          f"{label}: a train step did not take one rglru_scan and one "
          f"rglru_scan_bwd launch a RG-LRU layer")


def _train_full(ctx, dev):
    """RecurrentGemma-2B whole at full width (26 layers, bf16 weights drawn
    on the card) through launch.steps.make_train_step at B = 1, T in
    TRAIN_SEQS: every step's loss finite, 18 rglru_scan and 18
    rglru_scan_bwd launches a step and no plain version; step ms by CUDA
    events and by the host clock around a synchronized step, tokens/s,
    peak memory; one more step under torch.profiler (top device operations,
    busy share)."""
    import torch

    from repro_torch.kernels import common as kcommon
    from repro_torch.kernels.rglru import ops
    from repro_torch.launch import steps

    label = "train recurrentgemma-2b"
    t0 = time.perf_counter()
    cfg, params, rec = _load_model(ctx, label, "recurrentgemma-2b", None, "")
    n_rglru = cfg.layer_kinds().count("rglru")
    settings = steps.TrainSettings()
    opt = steps.init_opt_state(cfg, params, settings)
    step = steps.make_train_step(cfg, settings)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"{label}: params + AdamW state (fp32 m, v) {state_gb:.1f} GB on "
          f"the card before the first step")
    rec["state_gb"] = state_gb
    fwd, bwd = ops.rglru_scan, ops.rglru_scan_bwd
    runs = {}
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    grads_gb = 2 * rec["params"] / 1e9
    for T in TRAIN_SEQS:
        if T != TRAIN_SEQS[0]:
            # the gradient's peak past the state and the bf16 gradient
            # (the activations) grows with T, the update's does not
            t1 = TRAIN_SEQS[0]
            need = max(state_gb + grads_gb + (runs[t1]["grad_peak_gb"]
                                              - state_gb - grads_gb) * T / t1,
                       runs[t1]["update_peak_gb"])
            if need > total_gb - TRAIN_ROOM_GB:
                print(f"{label}: T={T} not run: its peak would be ~"
                      f"{need:.1f} GB, past the card's {total_gb:.1f} GB "
                      f"less {TRAIN_ROOM_GB:g}")
                continue
        batch = _train_batch(cfg, 1, T, seed=T, dev=dev)
        torch.cuda.reset_peak_memory_stats()
        losses, ev_ms, wall_ms = [], [], []
        for i in range(TRAIN_STEPS + 1):
            kcommon.reset_counts(fwd, bwd)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start.record()
            params, opt, m = step(params, opt, batch)
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - h0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            check(all(float(v) == float(v) and abs(float(v)) < float("inf")
                      for v in m.values()),
                  f"{label} T={T}: step {i}: non-finite metrics {m}")
            _train_counts(f"{label} T={T} step {i}", n_rglru)
            tally(ctx, fwd, bwd)
        peak = torch.cuda.max_memory_allocated() / 1e9
        med_ev = statistics.median(ev_ms[1:])
        med_wall = statistics.median(wall_ms[1:])
        r = dict(losses=losses, step_ms=ev_ms, wall_ms=wall_ms,
                 median_step_ms=med_ev, tokens_per_s=T / med_ev * 1e3,
                 peak_gb=peak)
        print(f"{label} B=1 T={T}: losses {[round(x, 4) for x in losses]}; "
              f"step ms by CUDA events {[round(x, 2) for x in ev_ms]} (the "
              f"first warm), host wall {[round(x, 2) for x in wall_ms]}; "
              f"median {med_ev:.2f} ms = {r['tokens_per_s']:.0f} tokens/s; "
              f"peak device memory {peak:.1f} GB")
        r.update(_train_split(f"{label} T={T}", cfg, settings, params, opt,
                              batch, n_rglru))
        tally(ctx, fwd, bwd)
        busy_ms = _train_profile(f"{label} T={T}", lambda: step(
            params, opt, batch), n_rglru)
        r["busy_ms"] = busy_ms
        runs[T] = r
        del batch
    rec["runs"] = runs
    _peak(ctx, label, rec, t0)
    ctx["train_full"] = rec
    del params, opt


def _short(name: str) -> str:
    """A device kernel's name without its namespaces and launch-shape
    template arguments: what it computes (its functor), 100 characters."""
    import re

    name = re.sub(r"at::native::|\(anonymous namespace\)::|void |"
                  r"c10::|std::|detail::", "", name)
    name = re.sub(r"^(vectorized_elementwise_kernel|unrolled_elementwise_"
                  r"kernel|elementwise_kernel)<\d+(, \d+)?, ", r"\1<", name)
    return name[:100]


def _train_split(label, cfg, settings, params, opt, batch, n_rglru):
    """One more step as make_train_step runs it, in its two halves:
    launch.steps.value_and_grad (forward and backward) and
    optim.apply_updates, each timed by CUDA events with its own peak
    device memory."""
    import torch

    from repro_torch.kernels import common as kcommon
    from repro_torch.kernels.rglru import ops
    from repro_torch.launch import steps
    from repro_torch.optim import apply_updates

    kcommon.reset_counts(ops.rglru_scan, ops.rglru_scan_bwd)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev[0].record()
    _, grads = steps.value_and_grad(cfg, params, batch)
    ev[1].record()
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ev[1].record()
    _, adam, _ = apply_updates(settings.adamw, params, grads, opt["adam"])
    ev[2].record()
    torch.cuda.synchronize()
    opt["adam"] = adam
    update_peak = torch.cuda.max_memory_allocated() / 1e9
    del grads
    grad_ms, update_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    print(f"{label}: a step in halves (CUDA events): loss and gradient "
          f"{grad_ms:.2f} ms (peak {grad_peak:.1f} GB), AdamW update "
          f"{update_ms:.2f} ms (peak {update_peak:.1f} GB)")
    _train_counts(f"{label} halves", n_rglru)
    return dict(grad_ms=grad_ms, update_ms=update_ms, grad_peak_gb=grad_peak,
                update_peak_gb=update_peak)


def _train_profile(label, fn, n_rglru):
    """One step under torch.profiler: its device operations by time (top
    12), the kernels' device ms and launches, the device's busy share."""
    import torch

    from repro_torch.kernels import common as kcommon
    from repro_torch.kernels.rglru import ops

    kcommon.reset_counts(ops.rglru_scan, ops.rglru_scan_bwd)
    wall_us, by_name, count = device_events(fn)
    busy = sum(by_name.values())
    check(busy > 0, f"{label}: the profiler saw no device time")
    top = "; ".join(f"{_short(name)} {us / 1e3:.2f} ms ({count[name]})"
                    for name, us in by_name.most_common(12))
    print(f"{label}: profiled step: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{sum(count.values())} device kernels; top: {top}")
    for kernel in ("rglru_scan", "rglru_scan_bwd"):
        ms, k = device_share(by_name, count, kernel)
        print(f"{label}: profiled step: {kernel} {ms:.3f} ms in {k} kernels")
        check(k == n_rglru, f"{label}: the profiler saw {k} {kernel} "
                            f"kernels for {n_rglru} RG-LRU layers")
    torch.cuda.synchronize()
    return busy / 1e3


def _grads_and_step(cfg, params, batch, lr):
    """(loss, grads, new params) of one step at lr (AdamW without warmup):
    launch.steps.value_and_grad then optim.apply_updates, what
    make_train_step runs; ``params`` is left as it was (the update runs on
    a copy)."""
    from repro_torch import tree as tr
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, apply_updates, init_state

    (loss, m), grads = steps.value_and_grad(cfg, params, batch)
    new = tr.tree_map(lambda p: p.clone(), params)
    new, _, _ = apply_updates(AdamWConfig(lr=lr, warmup_steps=0), new,
                              grads, init_state(new))
    return float(m["loss"]), tr.leaves(grads), tr.leaves(new)


def _hold_step(label, names, ref, got, lr, tol_loss, tol_grad,
               rel_loss=False):
    """A step's (loss, gradient leaves, new params) against a reference
    step's: the loss within ``tol_loss`` (relative with ``rel_loss``),
    each gradient leaf within ``tol_grad`` of its largest |reference|;
    each new parameter, past one ulp of a bf16 leaf, within
    TOL_TRAIN_WELL x lr where its reference gradient is larger than twice
    that gradient tolerance of the leaf's largest (so that its sign
    cannot flip between the two), and within TOL_TRAIN_STEP x lr
    elsewhere.  Returns the worst readings (loss, gradient leaf, well
    conditioned parameter, any parameter, the worst gradient leaf's
    name), or raises SmokeFailure naming the worst leaf past its
    tolerance."""
    import torch

    (l0, g0, p0), (l1, g1, p1) = ref, got
    e_loss = abs(l1 - l0) / (abs(l0) if rel_loss else 1.0)
    grads, wells, news = [], [], []
    for name, a, b, pa, pb in zip(names, g0, g1, p0, p1):
        a, b = a.float().cpu(), b.float().cpu()
        scale = float(a.abs().max())
        grads.append((float((a - b).abs().max()) / (scale or 1.0), name))
        bf16 = pb.dtype == torch.bfloat16
        pa, pb = pa.float().cpu(), pb.float().cpu()
        ulp = 2.0 ** -7 * torch.maximum(pa.abs(), pb.abs()) if bf16 else 0.0
        d = ((pa - pb).abs() - ulp) / lr
        news.append((float(d.max()), name))
        well = a.abs() > 2 * tol_grad * scale
        wells.append((float(d[well].max()) if bool(well.any()) else 0.0,
                      name))
    (e_grad, g_name), (e_well, w_name) = max(grads), max(wells)
    e_step, p_name = max(news)
    check(e_loss <= tol_loss, f"{label}: loss {l1:.6f} against {l0:.6f} "
                              f"({e_loss:.2e} > {tol_loss:g})")
    check(e_grad <= tol_grad, f"{label}: gradient of {g_name}: max |diff| "
                              f"{e_grad:.3e} of the leaf's largest > "
                              f"{tol_grad:g}")
    check(e_well <= TOL_TRAIN_WELL, f"{label}: updated {w_name} where its "
                                    f"gradient is large: {e_well:.3f} x lr "
                                    f"past one ulp > {TOL_TRAIN_WELL:g}")
    check(e_step <= TOL_TRAIN_STEP, f"{label}: updated {p_name}: "
                                    f"{e_step:.3f} x lr past one ulp > "
                                    f"{TOL_TRAIN_STEP:g}")
    return e_loss, e_grad, e_well, e_step, g_name


def _train_cut_vs_cpu(ctx, dev):
    """The first 3 layers (rglru, rglru, attn) of RecurrentGemma-2B at full
    width, bf16: one step on the card against the same step with
    device="cpu" on the chip machine's CPU (loss, every gradient leaf,
    every updated parameter), then again with rglru_scan_bwd's dlog_a
    zeroed, which that check must fail."""
    import torch

    from repro_torch import tree as tr
    from repro_torch.kernels.rglru import ops

    label = "train cut"
    cfg, params, rec = _load_model(ctx, label, "recurrentgemma-2b", 3,
                                   "the card against its CPU")
    names = ["/".join(str(k) for k in p)
             for p, _ in tr.leaves_with_path(params)]
    batch = _train_batch(cfg, 1, TRAIN_CPU_T, seed=5, dev=dev)
    card = _grads_and_step(cfg, params, batch, TRAIN_LR)
    cpu_params = tr.tree_map(lambda p: p.cpu(), params)
    t0 = time.perf_counter()
    cpu = _grads_and_step(cfg, cpu_params, {k: v.cpu()
                                            for k, v in batch.items()},
                          TRAIN_LR)
    cpu_s = time.perf_counter() - t0
    e_loss, e_grad, e_well, e_step, worst = _hold_step(
        label, names, cpu, card, TRAIN_LR, TOL_TRAIN_LOSS, TOL_TRAIN_GRAD)
    print(f"{label}: 3 layers at full width, B=1 T={TRAIN_CPU_T}, bf16, "
          f"card vs device=\"cpu\" ({cpu_s:.1f} s on the CPU): loss "
          f"{card[0]:.6f} vs {cpu[0]:.6f} (|diff| {e_loss:.2e}, tol "
          f"{TOL_TRAIN_LOSS:g}); gradients: worst leaf ({worst}) {e_grad:.3e} "
          f"of its largest (tol {TOL_TRAIN_GRAD:g}); updated params past one "
          f"bf16 ulp: worst {e_well:.3f} x lr where the gradient is large "
          f"(tol {TOL_TRAIN_WELL:g}), {e_step:.3f} x lr anywhere (tol "
          f"{TOL_TRAIN_STEP:g}; lr {TRAIN_LR:g}) over {len(names)} leaves")
    rec.update(loss_err=e_loss, grad_err=e_grad, well_err=e_well,
               step_err=e_step, cpu_s=cpu_s)

    real = ops.rglru_scan_bwd_cuda

    def lost_dlog_a(*args):
        dla, dgx, dh0 = real(*args)
        return torch.zeros_like(dla), dgx, dh0

    ops.rglru_scan_bwd_cuda = lost_dlog_a
    try:
        planted = _grads_and_step(cfg, params, batch, TRAIN_LR)
    finally:
        ops.rglru_scan_bwd_cuda = real
    try:
        _hold_step(label + " (planted)", names, cpu, planted, TRAIN_LR,
                   TOL_TRAIN_LOSS, TOL_TRAIN_GRAD)
        caught = None
    except SmokeFailure as err:
        caught = str(err)
    print(f"{label}: planted fault (rglru_scan_bwd's dlog_a zeroed): "
          f"{'caught: ' + caught if caught else 'NOT caught'}")
    check(caught is not None, f"{label}: the check did not see a lost "
                              "dlog_a")
    ctx["train_cut"] = rec
    del params, cpu_params, card, cpu, planted


def _train_matmul_f32(ctx, dev):
    """common.matmul_f32's backward (the bf16-operand, fp32-result products
    of the MoE experts, sLSTM and the unembed) on the card at olmoe-1b-7b's
    expert shape (64 experts, 16 slots, 2048 x 1024, bf16) against the
    fp32 products of the upcast operands rounded to bf16 once: each
    cotangent within one bf16 ulp of each element (at most 2^-7 of it:
    two fp32 sums in other orders may round to neighbouring bf16 values)
    plus 1e-6 of the largest."""
    import torch

    from repro_torch.models.layers import common

    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((64, 16, 2048), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    b = (torch.randn((64, 2048, 1024), generator=g, device=dev) / 45).to(
        torch.bfloat16).requires_grad_()
    w = torch.randn((64, 16, 1024), generator=g, device=dev)
    y = common.matmul_f32(a, b)
    da, db = torch.autograd.grad((y * w).sum(), (a, b))
    want_a = torch.bmm(w, b.detach().float().transpose(1, 2)).to(
        torch.bfloat16)
    want_b = torch.bmm(a.detach().float().transpose(1, 2), w).to(
        torch.bfloat16)
    errs = []
    for got, want in ((da, want_a), (db, want_b)):
        check(got.dtype == torch.bfloat16, "matmul_f32: a cotangent is not "
                                           "bf16")
        d = (got.float() - want.float()).abs()
        tol = 2.0 ** -7 * want.float().abs() + 1e-6 * float(
            want.float().abs().max())
        errs.append(float((d / tol.clamp_min(1e-30)).max()))
        check(bool((d <= tol).all()), "matmul_f32's backward disagrees with "
                                      "the fp32 products")
    print(f"train: matmul_f32 backward at olmoe's expert shape (64 x 16 x "
          f"2048 @ 2048 x 1024, bf16): dA, dB within {errs[0]:.2f}, "
          f"{errs[1]:.2f} of their tolerance (one bf16 ulp) of the fp32 "
          f"products")
    ctx["train_matmul_f32"] = dict(errs=errs)


def _train_reduced(ctx, dev):
    """Every reduced arch of the registry, fp32 and bf16: one
    make_train_step on the card against the same step on the CPU, from the
    same weights (drawn on the CPU) and batch: the loss, m (0.1 x the
    clipped gradient) of every leaf, the updated parameters."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch import tree as tr
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig

    settings = steps.TrainSettings(adamw=AdamWConfig(lr=TRAIN_LR,
                                                     warmup_steps=0))
    worst = {}
    for arch in configs.list_archs():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
            base = tf.init_params(cfg, torch.Generator().manual_seed(0))
            batch = _train_batch(cfg, 2, 16, seed=1, dev="cpu")
            out = []
            for where in ("cpu", "cuda"):
                p = tr.tree_map(lambda t: t.to(where, copy=True), base)
                b = {k: v.to(where) for k, v in batch.items()}
                p, o, m = steps.make_train_step(cfg, settings)(
                    p, steps.init_opt_state(cfg, p, settings), b)
                out.append((float(m["loss"]), tr.leaves(o["adam"]["m"]),
                            tr.leaves(p)))
            names = ["/".join(str(k) for k in q)
                     for q, _ in tr.leaves_with_path(base)]
            fp32 = dtype == "float32"
            e = _hold_step(f"train reduced {arch} {dtype}", names, *out,
                           TRAIN_LR,
                           TRAIN_RED_LOSS if fp32 else TOL_TRAIN_LOSS,
                           TRAIN_RED_M if fp32 else TOL_TRAIN_GRAD,
                           rel_loss=fp32)
            worst[f"{arch} {dtype}"] = e[:4]
            print(f"train reduced {arch} {dtype}: card vs CPU loss "
                  f"{out[1][0]:.6f} vs {out[0][0]:.6f} ({e[0]:.2e}"
                  f"{' rel' if fp32 else ''}); m worst leaf ({e[4]}) "
                  f"{e[1]:.2e} of its largest; params past one ulp "
                  f"{e[2]:.4f} x lr where m is large, {e[3]:.3f} x lr "
                  f"anywhere")
    ctx["train_reduced"] = worst


def _train_ft(ctx, dev):
    """runtime.TrainLoop at recurrentgemma-2b reduced (fp32) on the card:
    FT_STEPS steps of make_train_step with int8 compression, checkpoints
    every FT_EVERY; a fault at FT_FAULT restores the last checkpoint and
    replays; the final params and optimizer state equal an uninterrupted
    run's bit for bit."""
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch import tree as tr
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime import FTConfig, TrainLoop

    cfg = configs.get_reduced("recurrentgemma-2b")
    settings = steps.TrainSettings(
        compression=CompressionConfig(scheme="int8"))
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=4, seed=2))

    def run(directory, fail):
        p = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        loop = TrainLoop(steps.make_train_step(cfg, settings),
                         lambda i: {k: torch.from_numpy(v).to(dev)
                                    for k, v in data.batch_at(i).items()},
                         FTConfig(ckpt_dir=directory, ckpt_every=FT_EVERY))
        if fail is not None:
            loop.failure_at_steps.add(fail)
        p, o, step = loop.run(p, steps.init_opt_state(cfg, p, settings), 0,
                              FT_STEPS)
        return loop, tr.leaves((p, o)), step

    with tempfile.TemporaryDirectory() as tmp:
        clean, a, _ = run(os.path.join(tmp, "clean"), None)
        faulted, b, step = run(os.path.join(tmp, "faulted"), FT_FAULT)
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    replayed = [h["step"] for h in faulted.metrics_history]
    print(f"train ft: {cfg.name} {FT_STEPS} steps, int8 compression, "
          f"checkpoints every {FT_EVERY}, fault at step {FT_FAULT}: "
          f"restarts {faulted.restarts}, steps run {replayed}; final params "
          f"and optimizer state {'bit-equal to' if same else 'DIFFER from'} "
          f"the uninterrupted run's ({len(a)} leaves); losses "
          f"{[round(h['loss'], 4) for h in faulted.metrics_history]}")
    check(faulted.restarts == 1 and clean.restarts == 0 and step == FT_STEPS,
          "train ft: the fault did not restart the loop exactly once")
    check(same, "train ft: the recovered run's final state differs from "
                "the uninterrupted run's")
    ctx["train_ft"] = dict(restarts=faulted.restarts, steps=replayed)


#: the calib phase: BYSDNE's prefill shapes (B, T) and, from their B's,
#: the decode tick's chained and per-layer sides (the serve phases decode
#: at B = 4 and 2)
CALIB_BYSDNE_SHAPES = ((4, 30), (2, 30), (1, 30))
#: the stripes the planner weighs for EESEN's item under the card's model
#: (2, 4, 8 and the whole T, 300): each one's G=2 (fwd+bwd) and G=1 slots
#: are calibrated, so the measured model scores every road the planner
#: weighs on exact hits; at 300 only the G=2 slot a bt300 plan launches
CALIB_EESEN_STRIPES = (2, 4, 8, 300)
CALIB_REPEATS = 5
#: check_table's gross gate: a fresh replay within 25x of the stored
#: median either way (catches unit and lowering errors, not jitter)
CALIB_CHECK_TOL = 25.0
#: the planted table's factor on every chained-decode signature
CALIB_PLANT = 1000.0
CALIB_TICKS = 3


def _calib_candidates():
    """The candidates the card is calibrated on: what EESEN (B=4, T=300)
    and BYSDNE as an LSTM and a GRU launch under the card's model
    (``candidates_for``), EESEN's other stripes, and the smoke grid."""
    from types import SimpleNamespace

    from repro_torch import calib
    from repro_torch.configs.sharp_lstm import BYSDNE, eesen_demo
    from repro_torch.core.tiling import device_model

    card = device_model("cuda")
    eesen = eesen_demo()
    H = eesen.lstm_hidden
    cands = calib.candidates_for(eesen, shapes=((4, 300),),
                                 device_model=card)
    for bt in CALIB_EESEN_STRIPES:
        cands += [calib.Candidate("lstm", H, 2, 4, bt, dirs=("bwd", "fwd"))]
        if bt != 300:
            cands += [calib.Candidate("lstm", H, 1, 4, bt, dirs=(d,))
                      for d in ("fwd", "bwd")]
    for family in ("lstm", "gru"):
        stack = SimpleNamespace(families=(family,) * BYSDNE.n_layers,
                                H=BYSDNE.lstm_hidden, X=BYSDNE.lstm_input,
                                L=BYSDNE.n_layers, bidirectional=False)
        cands += calib.candidates_for(stack, shapes=CALIB_BYSDNE_SHAPES,
                                      device_model=card)
    return calib.dedupe(cands + calib.sweep_grid(**calib.SMOKE_GRID))


def _plan_us(model, slots) -> float:
    """The measured model's µs for a plan's launches."""
    return sum(model.slot_us(s.family, s.H, s.g, s.B, s.chunk_len, s.dtype,
                             tuple(c.direction for c in s.cells), s.chained,
                             s.precision) for s in slots)


def phase_calib(ctx):
    """The measured cost model on the card: calibrate, check the replay,
    then the EESEN forward and the BYSDNE serves under it, a planted table
    that flips the decode tick, and the CLI."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="calib-") as tmp:
        _calib(ctx, ctx["out"] or tmp)


def _calib(ctx, out):
    import torch

    from repro_torch import calib, rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    paths = {k: os.path.join(out, f"measured_costs{k}.json")
             for k in ("", "_planted", "_cli")}
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)
    rnn.resolve_device("cuda")
    card = f"cuda({torch.cuda.get_device_name(0)})"

    # 1. calibrate, counting every launch the replay makes
    cands = _calib_candidates()
    replayed = (lstm_seq, gru_seq, lstm_decode, gru_decode)
    everything = entries()
    reset_counts(*everything)
    print(f"calib: {len(cands)} candidates, {CALIB_REPEATS} timed replays "
          f"each after one warm-up (CUDA events around the eager call: the "
          f"entry point's host time and the kernel), on {ctx.get('card')}")
    t0 = time.perf_counter()
    table = calib.calibrate(cands, device="cuda", repeats=CALIB_REPEATS,
                            warmup=1, progress=print)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    table.save(paths[""])
    calls = {f.__name__: (f.calls, f.kernel_launches) for f in replayed}
    others = sum(f.calls for f in everything if f not in replayed)
    print(f"calib: table [{table.backend}], {len(table)} signatures in "
          f"{calib_s:.1f} s; entry point calls / kernel launches: "
          + ", ".join(f"{k} {c} / {n}" for k, (c, n) in calls.items())
          + f"; other entry points {others}")
    check(table.backend == card, f"the table is tagged {table.backend!r}, "
                                 f"not {card!r}")
    check(all(c > 0 and c == n for c, n in calls.values()) and others == 0,
          "a replay ran an entry point without launching its kernel (a "
          "plain version ran), or a family's kernel was never replayed")
    check(sum(c for c, _ in calls.values())
          == len(cands) * (1 + CALIB_REPEATS),
          "the replays' calls != candidates x (warm-up + repeats)")
    with open(paths[""]) as f:
        tags = sorted(json.load(f)["backends"])
    check(tags == [card], f"the saved table holds other tags: {tags}")
    bad = calib.check_table(table, device="cuda",
                            tolerance=CALIB_CHECK_TOL, progress=print)
    print(f"calib: check_table within {CALIB_CHECK_TOL:g}x: "
          f"{len(table) - len(bad)} of {len(table)} agree")
    check(not bad, f"replays disagree with the table beyond "
                   f"{CALIB_CHECK_TOL:g}x: {bad}")
    ctx["calib"] = {"backend": table.backend, "seconds": calib_s,
                    "table": {s: table.lookup(s) for s in
                              table.signatures()}}
    _calib_per_step_price(ctx, table)

    # 2. the EESEN forward, measured against analytic scoring
    _calib_forward(ctx, paths[""], table)

    # 3. BYSDNE served under the measured policy, as an LSTM and a GRU
    lstm_params = _bysdne("lstm")
    _serve_and_check(ctx, "calib_serve", "lstm", lstm_params, lstm_seq,
                     lstm_decode, cost_model="measured",
                     cost_table=paths[""])
    _serve_and_check(ctx, "calib_serve_gru", "gru", _bysdne("gru"), gru_seq,
                     gru_decode, cost_model="measured",
                     cost_table=paths[""])

    # 4. a planted table that prices the chain 1000x dearer
    _calib_planted(ctx, paths[""], paths["_planted"], table.backend,
                   lstm_params)

    # 5. the CLI on the card
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.calib", "--grid", "smoke",
         "--check", f"{CALIB_CHECK_TOL:g}", "--out", paths["_cli"]],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    tail = cli.stdout.strip().splitlines()[-2:]
    print(f"calib: python -m repro_torch.calib --grid smoke --check "
          f"{CALIB_CHECK_TOL:g}: exit {cli.returncode}; {' | '.join(tail)}")
    check(cli.returncode == 0, f"the calib CLI failed: "
                               f"{cli.stderr.strip()[-2000:]}")
    with open(paths["_cli"]) as f:
        tags = sorted(json.load(f)["backends"])
    check(tags == [card], f"the CLI's table holds other tags: {tags}")


def _calib_per_step_price(ctx, table):
    """The per_step schedule is priced as the lstm G=1 bt1 signature
    (replayed through lstm_seq, the reference's rule) while the card runs
    lstm_cell: both eager, by the same clock, for the record."""
    import torch

    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.runtime.obs import measure_samples, slot_signature

    sig = slot_signature("lstm", 340, 1, 4, 1, "float32")
    priced = table.lookup(sig)["med_us"]
    U, xw, h, c = _cell_case(4, 340, torch.float32, torch.float32, 7,
                             torch.device("cuda"))
    cell = statistics.median(measure_samples(lambda: lstm_cell(U, xw, h, c),
                                     repeats=CALIB_REPEATS, warmup=1))
    ctx["calib"]["per_step"] = {"priced_us": priced, "lstm_cell_us": cell}
    print(f"calib: per_step's price {sig} = {priced:.1f} us (lstm_seq); "
          f"lstm_cell, which per_step runs, eager at the same shape "
          f"{cell:.1f} us")


def _calib_forward(ctx, path, table):
    """rnn.compile(EESEN) under the measured policy: launches, stats and
    output against the analytic plan on the card, the plans, their warm
    walls in turns, and the model's µs for the chosen plan and for a
    bt300 plan (both plans under the card's device model)."""
    import numpy as np
    import torch

    from repro_torch import calib, rnn
    from repro_torch.configs.sharp_lstm import eesen_demo
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq

    cfg = eesen_demo()
    xs = (np.random.default_rng(1).standard_normal((4, 300, 340)) * 0.5
          ).astype(np.float32)
    analytic = rnn.compile(cfg, device="cuda", seed=0)
    measured = rnn.compile(cfg, rnn.ExecutionPolicy(
        cost_model="measured", cost_table=path), device="cuda", seed=0)
    everything = entries()
    reset_counts(*everything)
    ys = measured.forward(xs)
    torch.cuda.synchronize()
    n, p = lstm_seq.kernel_launches, measured.plan.launches
    others = sum(f.calls for f in everything if f is not lstm_seq)
    st = measured.stats
    check(tuple(ys.shape) == (4, 300, 680)
          and bool(torch.isfinite(ys).all()),
          "measured forward: wrong shape or not finite")
    check(n == p == lstm_seq.calls and others == 0,
          "measured forward: launches != plan.launches")
    check(st.degraded_launches == 0, "measured forward degraded")
    check(st.measured_hits > 0, "measured forward: no launch priced from "
                                "the table")
    tally(ctx, lstm_seq)
    ref = analytic.forward(xs)
    torch.cuda.synchronize()
    err = float((ys - ref).abs().max())
    check(err <= TOL_E2E, "measured forward disagrees with the analytic "
                          "plan's")

    walls = _turns({"analytic": lambda: analytic.forward(xs),
                    "measured": lambda: measured.forward(xs)},
                   ("analytic", "measured", "measured", "analytic"))
    model = calib.MeasuredCostModel(table)
    us = {"measured": _plan_us(model, measured.plan.slots),
          "analytic": _plan_us(model, analytic.plan.slots),
          "bt300": cfg.n_layers * model.slot_us(
              "lstm", 340, 2, 4, 300, "float32", ("bwd", "fwd"))}
    med = {k: statistics.median(v) for k, v in walls.items()}
    ctx["calib"]["forward"] = {
        "measured_items": _plan_items(measured.plan),
        "analytic_items": _plan_items(analytic.plan),
        "measured_launches": p, "analytic_launches": analytic.plan.launches,
        "walls_ms": walls, "model_us": us, "max_abs_err": err,
        "measured_hits": st.measured_hits,
        "analytic_fallbacks": st.analytic_fallbacks}
    print(f"calib forward: EESEN B=4 T=300 measured plan "
          f"{_plan_items(measured.plan)}, {p} launches ({st.measured_hits} hits with interpolated, "
          f"{st.analytic_fallbacks} analytic fallbacks); analytic plan "
          f"{_plan_items(analytic.plan)}, {analytic.plan.launches} launches; "
          f"max_abs_err {err:.3e} (tol {TOL_E2E:g})")
    print(f"calib forward: warm walls in turns (a, m, m, a) x3: measured "
          f"median {med['measured']:.2f} ms {['%.2f' % w for w in walls['measured']]}, "
          f"analytic median {med['analytic']:.2f} ms "
          f"{['%.2f' % w for w in walls['analytic']]}")
    print(f"calib forward: the model's us for the measured plan "
          f"{us['measured']:.1f}, the analytic plan {us['analytic']:.1f}, "
          f"and a bt300 plan ({cfg.n_layers} G=2 launches) "
          f"{us['bt300']:.1f}")


def _calib_planted(ctx, path, planted, backend, params):
    """The table with every chained-decode signature priced CALIB_PLANT x
    dearer must flip BYSDNE's decode tick to the per-layer plan on the
    card (5 lstm_seq launches a tick, no lstm_decode), with the chained
    tick's outputs."""
    import numpy as np
    import torch

    from repro_torch import rnn
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    with open(path) as f:
        raw = json.load(f)
    n_planted = 0
    for sig, e in raw["backends"][backend].items():
        if sig.endswith("|chained"):
            e["med_us"] *= CALIB_PLANT
            e["p90_us"] *= CALIB_PLANT
            n_planted += 1
    with open(planted, "w") as f:
        json.dump(raw, f)
    xs = (np.random.default_rng(2).standard_normal((4, 30, 340)) * 0.5
          ).astype(np.float32)
    flipped = rnn.compile(params, rnn.ExecutionPolicy(
        cost_model="measured", cost_table=planted), device="cuda")
    chained = rnn.compile(params, device="cuda")
    ys, st_f = flipped.prefill(xs)
    _, st_c = chained.prefill(xs)
    y_f = y_c = ys[:, -1:]
    everything = entries()
    err = 0.0
    for _ in range(CALIB_TICKS):
        reset_counts(*everything)
        y_f, st_f = flipped.decode(y_f, st_f)
        torch.cuda.synchronize()
        got = (lstm_seq.calls, lstm_seq.kernel_launches, lstm_decode.calls)
        p = flipped.last_decode_plan
        check(got == (5, 5, 0) and p.launches == 5
              and all(ip.schedule != "decode" for ip in p.items),
              f"the planted table did not flip the tick to 5 per-layer "
              f"launches: lstm_seq calls/launches, lstm_decode calls {got}")
        tally(ctx, lstm_seq)
        reset_counts(*everything)
        y_c, st_c = chained.decode(y_c, st_c)
        torch.cuda.synchronize()
        check(lstm_decode.kernel_launches == 1 and lstm_seq.calls == 0,
              "the analytic tick is not one lstm_decode launch")
        err = max(err, float((y_f - y_c).abs().max()),
                  *(float((st_f[k] - st_c[k]).abs().max()) for k in "hc"))
    ctx["calib"]["planted"] = {"chained_signatures": n_planted,
                               "max_abs_err": err}
    print(f"calib planted: {n_planted} chained signatures x{CALIB_PLANT:g}: "
          f"{CALIB_TICKS} BYSDNE ticks at B=4 ran 5 lstm_seq launches each "
          f"and no lstm_decode; vs the chained ticks max_abs_err {err:.3e} "
          f"(tol {TOL_FP32:g})")
    check(err <= TOL_FP32, "the flipped tick disagrees with the chained one")


# ---------------------------------------------------------------------------
# figures: the paper's figures and tables (benchmarks/paper_tables.py's rows)

#: Fig. 11's measured half at benchmarks/paper_tables.py's shape: H, T, B
FIG11_SHAPE = (256, 25, 1)
#: the five schedules are timed in turns, FIG11_ROUNDS rounds of
#: FIG11_REPEATS calls each (host-bound times drift within a call)
FIG11_ROUNDS = 3
FIG11_REPEATS = 10
#: Table 6's published E-PUR speedups per MAC budget (1K, 4K, 16K, 64K),
#: as benchmarks/paper_tables.py prints them beside the model's
TABLE6_PAPER = {"EESEN": (1.07, 1.25, 1.68, 1.9),
                "GMAT": (1.01, 1.51, 1.53, 1.66),
                "BYSDNE": (1.05, 1.24, 1.8, 2.22),
                "RLDRADSPR": (1.03, 1.11, 1.45, 2.3)}


def phase_figures(ctx):
    """The rows of benchmarks/paper_tables.py from the port's perfmodel
    (the paper's ASIC cycle model: host arithmetic), then Fig. 11's five
    schedules run on the card."""
    from repro_torch.configs.sharp_lstm import MAC_BUDGETS, SWEEP_HIDDEN_DIMS
    from repro_torch.core import perfmodel as pm

    rows = {}

    def emit(name, derived):
        rows[name] = derived
        print(f"figures: {name} {derived}")

    for m in MAC_BUDGETS:
        emit(f"fig9/best_k/macs{m}", ";".join(
            f"h{h}:K{k}" for h, k in pm.fig9_best_k(m).items()))
    pad = pm.fig10_padding_speedup()
    emit("fig10/max_speedup", f"{max(pad.values()):.3f}")
    emit("fig10/at_512",
         f"{statistics.mean(pad[(m, 512)] for m in MAC_BUDGETS):.3f}")
    sp = pm.fig11_schedule_speedups()
    for m in MAC_BUDGETS:
        for h in SWEEP_HIDDEN_DIMS:
            emit(f"fig11/model/macs{m}/h{h}", ";".join(
                f"{s}={sp[(m, h, s)]:.3f}" for s in
                ("sequential", "batch", "intergate", "unfolded")))
    f12 = pm.fig12_latency_utilization()
    for m in MAC_BUDGETS:
        avg = {k: statistics.mean(f12[(m, h)][k] for h in SWEEP_HIDDEN_DIMS)
               for k in ("latency_us", "utilization", "epur_utilization")}
        emit(f"fig12/macs{m}", f"latency_us={avg['latency_us']:.3f};"
             f"util={avg['utilization']:.2f};"
             f"epur_util={avg['epur_utilization']:.2f}")
    k_bw, penalty, eff = pm.fit_brainwave()
    emit("table4/bw_model_fit", f"k{k_bw};penalty{penalty};eff{eff}")
    t4 = pm.table4_vs_brainwave(k_bw, penalty, eff)
    for (h, steps), v in sorted(t4.items()):
        paper = pm.TABLE4_PAPER[(h, steps)]
        emit(f"table4/h{h}_t{steps}", f"ours={v:.2f};paper={paper};"
             f"relerr={abs(v - paper) / paper:.2f}")
    t6 = pm.table6_vs_epur()
    for name, paper in TABLE6_PAPER.items():
        for m, p in zip(MAC_BUDGETS, paper):
            emit(f"table6/{name}/macs{m}", f"ours={t6[(name, m)]:.2f};"
                 f"paper={p}")
    e = pm.fig14_energy()
    for m in MAC_BUDGETS:
        red = statistics.mean(e[(m, h)]["reduction"]
                              for h in SWEEP_HIDDEN_DIMS)
        emit(f"fig14/macs{m}", f"energy_reduction={red:.3f}")
    emit("fig14/gflops_per_watt_64k", f"{pm.gflops_per_watt():.0f}")
    emit("fig14/gflops_per_watt_paper_util",
         f"{pm.PEAK_TFLOPS[65536] * 0.5 / pm.POWER_W[65536] / 1e9:.0f}")
    # the model's own claims, as tests/core/test_perfmodel.py gates them
    check(all(sp[(m, h, "unfolded")] >= sp[(m, h, "intergate")] - 1e-9
              and sp[(m, h, "intergate")] >= sp[(m, h, "sequential")] - 1e-9
              for m in MAC_BUDGETS for h in SWEEP_HIDDEN_DIMS),
          "Fig. 11 model: unfolded >= intergate >= sequential fails")
    check(all(abs(v - pm.TABLE4_PAPER[k]) / pm.TABLE4_PAPER[k] < 0.35
              for k, v in t4.items()),
          "Table 4: the fitted BrainWave model is 35% off a paper entry")
    ctx["figures"] = {"model": rows, "measured_card": _fig11_measured(ctx)}


def _fig11_measured(ctx):
    """Fig. 11's functional schedules on the card: core.schedules.LAYER_FNS
    at FIG11_SHAPE, fp32, from seeded generators; fused makes one lstm_seq
    launch, the four research schedules none; each output against the
    same function on the CPU; times from runtime.obs.measure_us, the
    median of FIG11_ROUNDS rounds taken in turns."""
    import torch

    from repro_torch import rnn
    from repro_torch.core import schedules as sch
    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    from repro_torch.models.layers.lstm import init_lstm_layer
    from repro_torch.runtime.obs import measure_us

    H, T, B = FIG11_SHAPE
    dev = rnn.resolve_device("cuda")
    params = init_lstm_layer(torch.Generator().manual_seed(0), H, H,
                             torch.float32)
    xs = torch.randn((B, T, H), generator=torch.Generator().manual_seed(1))
    dparams = {k: v.to(dev) for k, v in params.items()}
    dxs = xs.to(dev)
    everything = entries()
    out = {}
    for s in sch.SCHEDULES:
        fn = sch.LAYER_FNS[s]
        reset_counts(*everything)
        ys = fn(dparams, dxs)
        torch.cuda.synchronize()
        want = 1 if s == "fused" else 0
        others = sum(f.calls for f in everything if f is not lstm_seq)
        check(lstm_seq.kernel_launches == lstm_seq.calls == want
              and others == 0,
              f"figures: {s} made {lstm_seq.kernel_launches} lstm_seq "
              f"launches ({lstm_seq.calls} calls, {others} other kernel "
              f"calls); expected {want} and none")
        tally(ctx, lstm_seq)
        ref = fn(params, xs)
        err = float((ys.cpu() - ref).abs().max())
        check(tuple(ys.shape) == (B, T, H) and bool(torch.isfinite(ys).all()),
              f"figures: {s} output has the wrong shape or is not finite")
        check(err <= TOL_FP32, f"figures: {s} disagrees with the CPU path")
        out[s] = {"rounds_us": [], "launches": want, "max_abs_err": err}
    for _ in range(FIG11_ROUNDS):
        for s in sch.SCHEDULES:
            out[s]["rounds_us"].append(measure_us(
                sch.LAYER_FNS[s], dparams, dxs, repeats=FIG11_REPEATS,
                warmup=1))
    for row in out.values():
        row["us"] = statistics.median(row["rounds_us"])
    for s, row in out.items():
        row["speedup_vs_sequential"] = out["sequential"]["us"] / row["us"]
        print(f"figures: fig11/measured_card/h{H}/{s} {row['us']:.1f} us "
              f"(median of {FIG11_ROUNDS} rounds in turns, each the median "
              f"of {FIG11_REPEATS} calls by obs.measure_us: "
              f"{', '.join(f'{u:.1f}' for u in row['rounds_us'])}), "
              f"{row['speedup_vs_sequential']:.3f}x_vs_seq; lstm_seq "
              f"launches {row['launches']}; max_abs_err vs CPU "
              f"{row['max_abs_err']:.3e} (tol {TOL_FP32:g})")
    return out


# ---------------------------------------------------------------------------
# chaos: fault isolation in the serving engine at BYSDNE's width

#: each scenario: the engine's pool, the requests (prompt length,
#: max_new_frames, max_ticks), the faults, the uid(s) expected to fail and
#: the word their error carries, and how many leading generated frames of
#: a faulted request still match the clean run
CHAOS_SCENARIOS = {
    "prefill_fault": dict(
        max_batch=3, requests=((30, 8, None), (30, 8, None), (17, 8, None)),
        fail_prefill_of={1}, poison={},
        faulted={1: ("failed", "launch fault")}, prefix=0),
    "poison_prefill": dict(
        max_batch=3, requests=((30, 8, None), (17, 8, None), (45, 8, None)),
        fail_prefill_of=set(), poison={2: -1},
        faulted={2: ("failed", "prefill state")}, prefix=0),
    "poison_decode": dict(
        max_batch=2, requests=((17, 8, None), (30, 8, None)),
        fail_prefill_of=set(), poison={0: 2},
        faulted={0: ("failed", "decode")}, prefix=2),
    "max_ticks": dict(
        max_batch=2, requests=((30, 16, 3), (30, 2, None)),
        fail_prefill_of=set(), poison={},
        faulted={0: ("timeout", "max_ticks=3")}, prefix=3),
}
#: a co-batched request in a faulted run against the fault-free run on
#: the card: bit for bit (the kernels split by shape alone, and a one-row
#: input product runs as two rows, dispatch.executor._hoist)
TOL_CHAOS = 0.0


def _chaos_frames(sc, seed):
    import numpy as np

    from repro_torch.configs.sharp_lstm import BYSDNE

    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((t, BYSDNE.lstm_input)) * 0.5)
            .astype(np.float32) for t, _, _ in sc["requests"]]


def _chaos_run(device, params, sc, frames, faulted: bool):
    """Serve a scenario's requests on ``device``; with ``faulted``, with
    its faults planted (a fault-free run keeps no max_ticks either)."""
    from repro_torch.configs.sharp_lstm import BYSDNE
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    eng = RecurrentServingEngine(BYSDNE, params, max_batch=sc["max_batch"],
                                 device=device, on_fault="fallback")
    if faulted:
        eng.fail_prefill_of = set(sc["fail_prefill_of"])
        eng.poison_slot_at = dict(sc["poison"])
    for uid, ((_, new, ticks), fr) in enumerate(zip(sc["requests"], frames)):
        eng.submit(RecurrentRequest(uid=uid, frames=fr, max_new_frames=new,
                                    max_ticks=ticks if faulted else None))
    return eng, {c.uid: c for c in eng.run_to_completion()}


def _chaos_counters(eng, done):
    st = eng.compiled.stats
    return {"completions": [(u, c.status, c.outputs.shape,
                             c.generated.shape, c.error is None)
                            for u, c in sorted(done.items())],
            "prefill_waves": eng.prefill_waves,
            "packed_launches": eng.packed_launches,
            "naive_launches": eng.naive_launches,
            "decode_ticks": eng.decode_ticks,
            "decode_launches": eng.decode_launches,
            "quarantined": eng.quarantined,
            "prefill_retries": eng.prefill_retries,
            "dropped": eng.dropped,
            "degraded_launches": st.degraded_launches,
            "fallback_level": st.fallback_level}


def _frames_diff(a, b):
    """(max |a - b|, bit-equal) of two frame arrays of one shape."""
    import numpy as np

    if a.shape != b.shape:
        return float("inf"), False
    d = float(np.abs(a - b).max()) if a.size else 0.0
    return d, bool(np.array_equal(a, b))


def phase_chaos(ctx):
    """The chaos suite's isolation scenarios (tests/test_torch_faults.py)
    on the card at BYSDNE's width: statuses and counters against a
    device="cpu" engine given the same scenario, kernel launches against
    the engine's counts, co-batched requests against the fault-free card
    run."""
    import numpy as np
    import torch

    from repro_torch.kernels.common import reset_counts
    from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq

    params = _bysdne("lstm")
    everything = entries()
    record = {}
    for i, (name, sc) in enumerate(CHAOS_SCENARIOS.items()):
        frames = _chaos_frames(sc, seed=10 + i)
        _, clean = _chaos_run("cuda", params, sc, frames, faulted=False)
        reset_counts(*everything)
        eng, done = _chaos_run("cuda", params, sc, frames, faulted=True)
        torch.cuda.synchronize()
        seq_n, dec_n = lstm_seq.kernel_launches, lstm_decode.kernel_launches
        seq_c, dec_c = lstm_seq.calls, lstm_decode.calls
        others = sum(f.calls for f in everything
                     if f not in (lstm_seq, lstm_decode))
        tally(ctx, lstm_seq, lstm_decode)
        card = _chaos_counters(eng, done)
        cpu_eng, cpu_done = _chaos_run("cpu", params, sc, frames,
                                       faulted=True)
        cpu = _chaos_counters(cpu_eng, cpu_done)
        print(f"chaos: {name}: statuses "
              f"{[done[u].status for u in sorted(done)]}; waves "
              f"{card['prefill_waves']} ({card['packed_launches']} planned "
              f"launches), ticks {card['decode_ticks']} "
              f"({card['decode_launches']}); quarantined "
              f"{card['quarantined']}, prefill_retries "
              f"{card['prefill_retries']}, dropped {card['dropped']}; kernel "
              f"launches lstm_seq {seq_n}, lstm_decode {dec_n}")
        check(card == cpu, f"chaos: {name}: the card's statuses and "
                           f"counters {card} != the CPU engine's {cpu}")
        check(seq_n == seq_c == eng.packed_launches
              and dec_n == dec_c == eng.decode_launches and others == 0,
              f"chaos: {name}: kernel launches (lstm_seq {seq_n} of {seq_c} "
              f"calls, lstm_decode {dec_n} of {dec_c}, {others} other "
              f"kernel calls) != the "
              f"engine's ({eng.packed_launches}, {eng.decode_launches})")
        for uid, (status, word) in sc["faulted"].items():
            c = done[uid]
            check(c.status == status and word in (c.error or ""),
                  f"chaos: {name}: uid {uid} ended {c.status!r} "
                  f"({c.error!r}); expected {status!r} naming {word!r}")
        rows = {}
        for uid in sorted(done):
            c = done[uid]
            if uid in sc["faulted"]:
                k = sc["prefix"]
                check(c.generated.shape[0] == k,
                      f"chaos: {name}: uid {uid} kept "
                      f"{c.generated.shape[0]} frames; expected {k}")
                pairs = [("generated", clean[uid].generated[:k],
                          c.generated)]
            else:
                check(c.status == "ok", f"chaos: {name}: co-batched uid "
                                        f"{uid} ended {c.status!r}")
                pairs = [("outputs", clean[uid].outputs, c.outputs),
                         ("generated", clean[uid].generated, c.generated)]
                e2e = max(float(np.abs(c.outputs
                                       - cpu_done[uid].outputs).max()),
                          float(np.abs(c.generated
                                       - cpu_done[uid].generated).max()))
                check(e2e <= TOL_E2E, f"chaos: {name}: uid {uid} disagrees "
                                      "with the CPU engine")
            kept = "(the faulted request's kept frames) " \
                if uid in sc["faulted"] else ""
            for what, a, b in pairs:
                d, same = _frames_diff(a, b)
                rows[f"uid{uid}/{what}"] = {"max_abs_diff": d,
                                            "bit_equal": same}
                print(f"chaos: {name}: uid {uid} {what} {kept}"
                      f"vs the fault-free card run: max |diff| {d:.3e}, "
                      f"{'bit-equal' if same else 'NOT bit-equal'} (tol "
                      f"{TOL_CHAOS:g})")
                check(d <= TOL_CHAOS, f"chaos: {name}: uid {uid}'s {what} "
                                      "departs from the fault-free run")
        record[name] = {"counters": {k: v for k, v in card.items()
                                     if k != "completions"},
                        "statuses": {u: done[u].status for u in done},
                        "kernel_launches": {"lstm_seq": seq_n,
                                            "lstm_decode": dec_n},
                        "isolation": rows}
    ctx["chaos"] = record


# ---------------------------------------------------------------------------
# mesh: the port's sharding on the card
# ---------------------------------------------------------------------------

#: (a): starcoder2-3b whole on a 1x1 mesh, its prompts' lengths, the
#: decode steps after them and the rings' length
MESH_ARCH = "starcoder2-3b"
MESH_PROMPTS = (24, 100, 200, 300)
MESH_STEPS = 8
MESH_SEQ = 512
#: (c): the reference's own tolerances for the sharded runs it holds
#: against one device (tests/test_sharding.py): the tensor-parallel LSTM
#: and the decode on a sequence-sharded ring
TOL_TP = 1e-5
TOL_SEQ = 2e-4
#: (c)'s shapes: the TP LSTM (H, B, T) and the reduced decode's (B, S,
#: ring, steps)
MESH_TP = (340, 4, 300)
MESH_SEQ_CASE = (4, 24, 32, 3)


def _mesh_group(backend: str, rank: int, world: int, store: str):
    """A process group over ``world`` ranks meeting at a FileStore."""
    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _tree_equal(a, b) -> bool:
    from repro_torch import tree as tr

    return all(bool(x.dtype == y.dtype and x.shape == y.shape
                    and (x == y).all()) for x, y in
               zip(tr.leaves(a), tr.leaves(b)))


def _whole(tree):
    """A tree's DTensor leaves gathered whole (plain leaves as they are)."""
    from repro_torch import tree as tr
    from repro_torch.sharding.partition import is_dtensor

    return tr.tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                       tree)


def phase_mesh(ctx):
    """(a) the sharded decode at full width and (b) the reduced train step
    on a 1x1 mesh over NCCL, bit for bit against the same steps with no
    mesh; (c) two ranks sharing the card."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import rnn

    dev = rnn.resolve_device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx["mesh_tmp"] = tmp
    _mesh_group("nccl", 0, 1, os.path.join(tmp, "store1"))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        print(f"mesh: {mesh} over NCCL, world size 1")
        _mesh_decode(ctx, dev, mesh)
        _mesh_train(dev, mesh)
    finally:
        dist.destroy_process_group()
    _free()
    _mesh_two_ranks(ctx, dev)


def _mesh_prompts(cfg, dev):
    import torch

    g = torch.Generator().manual_seed(280)
    return [torch.randint(0, cfg.vocab_size, (1, n), generator=g).to(dev)
            for n in MESH_PROMPTS]


def _mesh_batch_cache(caches):
    """The prompts' B=1 caches as one B=4 cache (rows in prompt order)."""
    import torch

    return {"layers": {k: torch.cat([c["layers"][k] for c in caches], 1)
                       for k in caches[0]["layers"]},
            "idx": torch.cat([c["idx"] for c in caches])}


def _mesh_profile(store: str, out: str):
    """The profile worker: (a)'s mesh, params and prompts drawn as the
    phase draws them, one decode step at B=4 after the prefills under the
    profiler; saves {kernel: (device ms, launches seen)} to ``out``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.common import sharding_ctx
    from repro_torch.sharding.partition import (cache_shardings,
                                                distribute, param_shardings)

    _mesh_group("nccl", 0, 1, store)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg, params, _ = _load_model({}, "mesh profile", MESH_ARCH, None, "")
    with sharding_ctx(mesh):
        sharded = distribute(params, param_shardings(params, mesh,
                                                     fsdp=False))
        pre, caches = [], []
        for tok in _mesh_prompts(cfg, torch.device("cuda")):
            lg, c = tf.prefill(cfg, sharded, {"tokens": tok},
                               seq_len=MESH_SEQ)
            pre.append(_whole(lg))
            caches.append(_whole(c))
        cache = _mesh_batch_cache(caches)
        cache = distribute(cache, cache_shardings(cache, mesh))
        tok = torch.stack([x[0, -1].argmax() for x in pre])[:, None].int()
        by_name, count = _device_kernels(
            lambda: tf.decode_step(cfg, sharded, cache, {"tokens": tok}))
    torch.save({k: device_share(by_name, count, k)
                for k in ("mvm", "decode_attention")}, out)
    torch.distributed.destroy_process_group()


def _mesh_subprocess(tmp: str, task: str, world: int):
    """Run ``world`` processes of this script as ``--mesh-worker`` for
    ``task``; returns what rank 0 saved."""
    import torch

    out = os.path.join(tmp, f"{task}.pt")
    store = os.path.join(tmp, f"store_{task}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker",
         f"{task},{r},{world},{store},{out}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            print(f"mesh: {task} rank {r} of {world} exited "
                  f"{p.returncode}:\n" + log[-3000:])
    check(all(p.returncode == 0 for p in procs),
          f"mesh: a rank of the {task} run failed")
    return torch.load(out), logs


def _device_kernels(fn):
    """(device us by kernel name, events by kernel name) of ``fn`` under a
    CUDA-only torch.profiler trace that a finished kernel has opened, so
    that the trace is live before ``fn``'s first launch (in one full run
    a CPU-and-CUDA trace of a mesh step saw 178 of its 180 mvm
    launches)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    count = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
    return by_name, count


def _mesh_decode(ctx, dev, mesh):
    """(a): prefill each prompt, then MESH_STEPS decode steps at B=4 of
    their rows, with no mesh and on ``mesh`` (params by param_specs(fsdp=
    False), rings by cache_specs); every logit and ring bit for bit."""
    import torch

    from repro_torch.kernels import decode_attention, mvm
    from repro_torch.kernels.common import reset_counts
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.common import sharding_ctx
    from repro_torch.sharding.partition import (cache_shardings,
                                                distribute, param_shardings)

    cfg, params, _ = _load_model(ctx, "mesh", MESH_ARCH, None, "")
    L = cfg.n_layers
    prompts = _mesh_prompts(cfg, dev)

    def run(p, on_mesh: bool):
        """Prefill logits, the steps' logits, tick ms (CUDA events), the
        final cache and each step's launches."""
        pre, caches = [], []
        for tok in prompts:
            lg, c = tf.prefill(cfg, p, {"tokens": tok}, seq_len=MESH_SEQ)
            pre.append(_whole(lg))
            caches.append(_whole(c))
        cache = _mesh_batch_cache(caches)
        if on_mesh:
            cache = distribute(cache, cache_shardings(cache, mesh))
        tok = torch.stack([x[0, -1].argmax() for x in pre])[:, None].int()
        outs, ticks, counts = [], [], []
        for _ in range(MESH_STEPS):
            n0 = (mvm.kernel_launches, decode_attention.kernel_launches)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            lg, cache = tf.decode_step(cfg, p, cache, {"tokens": tok})
            e1.record()
            torch.cuda.synchronize()
            ticks.append((e0.elapsed_time(e1),
                          (time.perf_counter() - t0) * 1e3))
            counts.append((mvm.kernel_launches - n0[0],
                           decode_attention.kernel_launches - n0[1]))
            lg = _whole(lg)
            outs.append(lg)
            tok = lg[:, -1].argmax(-1)[:, None].int()
        return pre, outs, ticks, _whole(cache), counts

    plain = run(params, False)
    with sharding_ctx(mesh):
        sharded = distribute(params, param_shardings(params, mesh,
                                                     fsdp=False))
        placed = sorted({str(t.placements) for t in _leaves(sharded)})
        reset_counts(mvm, decode_attention)
        got = run(sharded, True)
        launched = (mvm.kernel_launches, decode_attention.kernel_launches)
        tally(ctx, mvm, decode_attention)
    pre_same = all(bool(torch.equal(a, b)) for a, b in zip(plain[0], got[0]))
    step_same = all(bool(torch.equal(a, b)) for a, b in zip(plain[1],
                                                            got[1]))
    ring_same = _tree_equal(plain[3], got[3])
    per_step = set(got[4])
    med = lambda xs, i: statistics.median(x[i] for x in xs)  # noqa: E731
    print(f"mesh: {MESH_ARCH} L={L} on the 1x1 mesh, params placed "
          f"{placed}; prefills of {list(MESH_PROMPTS)} tokens (rings of "
          f"{MESH_SEQ}), {MESH_STEPS} decode steps at B=4: prefill logits "
          f"bit-equal to no mesh {pre_same}, every step's logits {step_same}"
          f", the final rings and cursor {ring_same}; launches a step (mvm, "
          f"decode_attention) {sorted(per_step)} for 6 L = {6 * L}, L = {L}")
    check(pre_same and step_same and ring_same,
          "mesh: the 1x1 mesh's prefill or decode differs from no mesh")
    check(per_step == {(6 * L, L)}, f"mesh: a step launched {per_step}, "
                                    f"not ({6 * L}, {L})")
    # the device's own count of one step's kernels, in a fresh process: in
    # a full run, after the serving phases' traces, the profiler saw 178 of
    # a mesh step's 180 mvm launches (twice), and all 180 in a process
    # that had traced nothing before
    prof = _mesh_subprocess(ctx["mesh_tmp"], "profile", 1)[0]
    for kernel, n in (("mvm", 6 * L), ("decode_attention", L)):
        ms, seen = prof[kernel]
        print(f"mesh: profile (one step, a fresh process): {kernel} "
              f"{ms:.3f} ms of device in {seen} launches (counted {n})")
        check(seen == n, f"mesh: the profiler saw {seen} {kernel} kernels "
                         f"for {n} launches")
    tick = (med(plain[2], 0), med(got[2], 0), med(plain[2], 1),
            med(got[2], 1))
    print(f"mesh: a B=4 tick, median of {MESH_STEPS} (CUDA events / host "
          f"wall, ms): no mesh {tick[0]:.3f} / {tick[2]:.3f}, 1x1 mesh "
          f"{tick[1]:.3f} / {tick[3]:.3f}: DTensor's host cost "
          f"{tick[3] - tick[2]:.3f} ms a step; card {ctx.get('card')}")
    ctx["mesh"] = dict(tick_ms=tick[0], mesh_tick_ms=tick[1],
                       wall_ms=tick[2], mesh_wall_ms=tick[3],
                       launches=launched)
    del params, sharded, plain, got
    _free()


def _mesh_train(dev, mesh):
    """(b): the reduced starcoder2-3b train step on the 1x1 mesh (params,
    moments and batch distributed) against the same step with no mesh."""
    import torch

    from repro_torch import tree as tr
    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.common import sharding_ctx
    from repro_torch.sharding.partition import (NamedSharding, batch_spec,
                                                distribute, param_shardings)

    cfg = get_reduced(MESH_ARCH)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(29))
    opt = init_opt_state(cfg, params)
    g = torch.Generator().manual_seed(281)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16),
                                     generator=g).to(dev)}
    step = make_train_step(cfg)
    clone = lambda t: tr.tree_map(lambda x: x.clone(), t)  # noqa: E731
    p1, o1, m1 = step(clone(params), clone(opt), batch)
    with sharding_ctx(mesh):
        p2 = distribute(clone(params), param_shardings(params, mesh))
        o2 = distribute(clone(opt), param_shardings(opt, mesh))
        b2 = distribute(batch, tr.tree_map(lambda s: NamedSharding(mesh, s),
                                           batch_spec(mesh, batch)))
        p3, o3, m3 = step(p2, o2, b2)
        p3, o3 = _whole(p3), _whole(o3)
    same = (bool(torch.equal(m1["loss"], m3["loss"])), _tree_equal(p1, p3),
            _tree_equal(o1, o3))
    print(f"mesh: reduced {MESH_ARCH} train step (fp32, B=8 T=16) on the "
          f"1x1 mesh: loss {float(m3['loss']):.6f} bit-equal to no mesh "
          f"{same[0]}, params {same[1]}, AdamW state {same[2]}")
    check(all(same), "mesh: the 1x1 mesh's train step differs from no mesh")


def _mesh_tp_case(dev):
    """(params, xs) of (c)'s TP LSTM layer, fp32, from seeded generators."""
    import torch

    from repro_torch.models.layers.lstm import init_lstm_layer

    H, B, T = MESH_TP
    params = init_lstm_layer(torch.Generator().manual_seed(282), H, H,
                             torch.float32, device=dev)
    g = torch.Generator().manual_seed(283)
    xs = (torch.randn((B, T, H), generator=g) * 0.5).to(dev)
    return params, xs


def _mesh_seq_case(dev):
    """(cfg, params, tokens) of (c)'s reduced decode."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tf

    cfg = get_reduced(MESH_ARCH)
    params = tf.init_params(cfg, torch.Generator().manual_seed(284),
                            device=dev)
    B, S, _, _ = MESH_SEQ_CASE
    g = torch.Generator().manual_seed(285)
    return cfg, params, torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=g).to(dev)


def _mesh_seq_decode(cfg, params, tokens):
    """(c)'s prefill and decode steps: the steps' logits."""
    import torch

    from repro_torch.models import transformer as tf

    B, _, ring, steps = MESH_SEQ_CASE
    _, cache = tf.prefill(cfg, params, {"tokens": tokens}, seq_len=ring)
    outs = []
    for t in range(steps):
        tok = torch.full((B, 1), t + 5, dtype=torch.int32,
                         device=tokens.device)
        lg, cache = tf.decode_step(cfg, params, cache, {"tokens": tok})
        outs.append(_whole(lg))
    return outs


def mesh_worker(spec: str) -> int:
    """A process of the mesh phase (``--mesh-worker task,rank,world,store,
    out``): task "profile" (``_mesh_profile``), or "ranks", one of (c)'s
    ranks: the TP LSTM and the sequence-sharded decode on cuda:0 over
    gloo; rank 0 saves the gathered outputs to ``out``."""
    task, rank, world, store, out = spec.split(",")
    rank, world = int(rank), int(world)
    sys.path.insert(0, SRC)
    if task == "profile":
        _mesh_profile(store, out)
        return 0
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import rnn
    from repro_torch.core.unfolded import run_layer_unfolded_tp
    from repro_torch.kernels import decode_attention, mvm
    from repro_torch.kernels.common import reset_counts
    from repro_torch.models.layers.common import DEFAULT_RULES, sharding_ctx
    from repro_torch.sharding import local
    from repro_torch.sharding.partition import distribute, param_shardings

    dev = rnn.resolve_device("cuda")
    torch.cuda.set_device(0)
    _mesh_group("gloo", rank, world, store)
    res = {}
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
    params, xs = _mesh_tp_case(dev)
    reset_counts(mvm)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = run_layer_unfolded_tp(params, xs, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["tp"] = hs.full_tensor().cpu()
    res["tp_ms"] = statistics.median(times)
    res["tp_mvm"] = mvm.kernel_launches // 3
    # one step's collective alone: the gates' all-gather, (B, 4H/n) each
    H, B, _ = MESH_TP
    part = torch.randn((B, 4 * H // world), device=dev)
    gather = lambda: local.all_gather_over(part, mesh, 0, 1)  # noqa: E731
    gather()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        gather()
    torch.cuda.synchronize()
    res["gather_ms"] = (time.perf_counter() - t0) * 1e3 / 100
    # the sequence-sharded decode: the ring's T over model, the weights
    # (all below the rules' size threshold) and activations replicated:
    # DTensor's own collectives crash under gloo on CUDA tensors
    # (PyTorch 2.11), so the only collectives are the combine's, c10d's
    mesh2 = init_device_mesh("cuda", (1, world),
                             mesh_dim_names=("data", "model"))
    cfg, params, tokens = _mesh_seq_case(dev)
    with sharding_ctx(mesh2, rules={k: None for k in DEFAULT_RULES}):
        sharded = distribute(params, param_shardings(params, mesh2,
                                                     fsdp=False))
        reset_counts(decode_attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["seq"] = [x.cpu() for x in _mesh_seq_decode(cfg, sharded, tokens)]
        torch.cuda.synchronize()
        res["seq_ms"] = (time.perf_counter() - t0) * 1e3
        res["seq_attn"] = decode_attention.kernel_launches
    res["backend"] = dist.get_backend()
    if rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mesh_two_ranks(ctx, dev):
    """(c): two processes on cuda:0 form a gloo group (NCCL refuses two
    ranks on one device) and run mesh_worker; their gathered outputs
    against the 1-rank card runs."""
    from repro_torch.core.schedules import run_layer_unfolded

    res = _mesh_subprocess(ctx["mesh_tmp"], "ranks", 2)[0]
    params, xs = _mesh_tp_case(dev)
    ref = run_layer_unfolded(params, xs).cpu()
    tp_err = float((res["tp"] - ref).abs().max())
    cfg, params, tokens = _mesh_seq_case(dev)
    seq_ref = [x.cpu() for x in _mesh_seq_decode(cfg, params, tokens)]
    seq_err = max(float((a - b).abs().max())
                  for a, b in zip(res["seq"], seq_ref))
    H, B, T = MESH_TP
    L = cfg.n_layers
    steps = MESH_SEQ_CASE[3]
    print(f"mesh: two ranks on cuda:0 over {res['backend']}: "
          f"run_layer_unfolded_tp H={H} B={B} T={T} (gate axis over "
          f"model=2, {res['tp_mvm']} mvm launches a rank) max |diff| "
          f"{tp_err:.3e} against the 1-rank card run (TOL_TP {TOL_TP:g}), "
          f"{res['tp_ms']:.1f} ms a layer, the gates' all-gather "
          f"{res['gather_ms']:.4f} ms a step; reduced {MESH_ARCH} decode, "
          f"ring T={MESH_SEQ_CASE[2]} over model=2 ({res['seq_attn']} "
          f"decode_attention launches a rank for {steps} steps x {L} "
          f"layers), max |diff| {seq_err:.3e} against the 1-rank card "
          f"decode (TOL_SEQ {TOL_SEQ:g}), {res['seq_ms']:.1f} ms for the "
          f"prefill and {steps} steps")
    check(tp_err <= TOL_TP, f"mesh: TP LSTM off by {tp_err:.3e}")
    check(seq_err <= TOL_SEQ, f"mesh: sequence-sharded decode off by "
                              f"{seq_err:.3e}")
    check(res["tp_mvm"] == T and res["seq_attn"] == steps * L,
          "mesh: the two-rank run's launches are not T mvm and steps x L "
          "decode_attention a rank")
    ctx["mesh"].update(tp_err=tp_err, seq_err=seq_err, tp_ms=res["tp_ms"],
                       gather_ms=res["gather_ms"], seq_ms=res["seq_ms"])


#: the cost phase's cases (label, arch, mode, B, T): two decode steps at
#: B = 4 on serve_dense's 4096-slot rings and the train step of the train
#: phase (B = 1, T = 1024), each at full width and depth
COST_CASES = (("cost starcoder2-3b decode", "starcoder2-3b", "decode", 4,
               4096),
              ("cost olmoe-1b-7b decode", "olmoe-1b-7b", "decode", 4, 4096),
              ("cost recurrentgemma-2b train", "recurrentgemma-2b", "train",
               1, 1024))
#: (iii): the trace's high-water mark of the step's own storages against
#: the growth of torch.cuda.max_memory_allocated() over the step, within
#: this share of the growth plus this many bytes (PERF.md, PR 29)
COST_PEAK_REL = 0.05
COST_PEAK_ABS = 4 * 2**20
#: (iv): the walker's bound may be at most this multiple of the step's time
COST_BOUND_SHARE = 1.05
#: eager steps timed by CUDA events for (iv)
COST_TIMED_STEPS = 3


def phase_cost(ctx):
    """The static cost walker (``calib.hlo``) against the card, at full
    width, one card, eager: for each of COST_CASES the step is traced on
    the host first (fake tensors of the card's arguments: nothing runs on
    the card), then run on the card, and (i) the kernel ops the trace
    recorded equal each entry point's counted launches; (ii) the trace's
    FLOPs outside the kernels equal FlopCounterMode's count of the card's
    step, and its kernel FLOPs the sum of each launch's ``Cost``
    (``calib.hlo.Meter``); where the card computes more than the function
    (``common.matmul_f32``'s three bf16 products a cotangent) the
    difference against a trace of the CPU's path is held to its closed
    form; (iii) the trace's high-water mark matches the growth of
    max_memory_allocated over the step within COST_PEAK_REL and
    COST_PEAK_ABS; (iv) the walker's bound, max(bytes / HBM rate, FLOPs /
    the bf16 peak), is at most COST_BOUND_SHARE x the step's time."""
    import torch

    from repro_torch import rnn

    dev = rnn.resolve_device("cuda")
    _free()
    recs = {}
    for case in COST_CASES:
        recs[case[0]] = _cost_case(ctx, dev, *case)
        _free()
    ctx["cost"] = recs
    torch.cuda.synchronize()


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__):
    """``torch.utils.flop_counter``'s bmm formula, which takes the
    ``aten::bmm.dtype`` overload's out_dtype for an output shape."""
    from torch.utils.flop_counter import bmm_flop

    return bmm_flop(a_shape, b_shape)


def _dtype_bmm():
    import torch

    return {torch.ops.aten.bmm: _bmm_flops}


def _cost_args(cfg, params, mode, B, T, dev):
    """(step, args) of ``mode`` on the card: a decode step's cache of T
    slots with every row at position T // 2, or the train step's AdamW
    state and a batch of the synthetic pipeline."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    if mode == "decode":
        cache = tf.init_cache(cfg, B, T, device=dev)
        cache["idx"].fill_(T // 2)
        g = torch.Generator(device=dev).manual_seed(290)
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                               device=dev, dtype=torch.int32)
        return steps.make_serve_step(cfg), (params, cache,
                                            {"tokens": tokens})
    settings = steps.TrainSettings()
    opt = steps.init_opt_state(cfg, params, settings)
    return (steps.make_train_step(cfg, settings),
            (params, opt, _train_batch(cfg, B, T, seed=291, dev=dev)))


def _cost_case(ctx, dev, label, arch, mode, B, T):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.calib import hlo
    from repro_torch.configs.base import H100
    from repro_torch.kernels import common as kcommon

    cfg, params, rec = _load_model(ctx, label, arch, None, "")
    step, args = _cost_args(cfg, params, mode, B, T, dev)
    grad = torch.enable_grad() if mode == "train" else torch.no_grad()

    # the trace, on the host: fake tensors of the arguments
    h0 = time.perf_counter()
    with grad:
        trace, _ = hlo.run(step, *args, label=label)
    trace_s = time.perf_counter() - h0
    text = trace.text()
    cost = hlo.analyze(text)
    ops = hlo.parse(text)
    k_flops = sum(float(o.attrs.get("flops", 0)) for o in ops
                  if o.name.startswith("kernel."))
    other_flops = cost["flops"] - k_flops
    if ctx.get("out"):
        import gzip

        path = os.path.join(ctx["out"], label.replace(" ", "_") + ".hlo.gz")
        with gzip.open(path, "wt") as f:
            f.write(text)
    print(f"{label}: traced on the host in {trace_s:.1f} s: {len(ops)} "
          f"operations, kernel ops {dict(trace.kernels)}; FLOPs "
          f"{cost['flops']:.6e} (kernels {k_flops:.6e}), bytes "
          f"{cost['bytes']:.6e}, transcendentals "
          f"{cost['transcendental_elems']:.6e}; predicted high-water "
          f"{trace.memory.high_water} bytes over the arguments' "
          f"{trace.memory.argument_bytes}")

    with grad:
        step(*args)  # warm: the libraries' workspaces
        torch.cuda.synchronize()
        # (i), (ii) kernels, (iii): one counted, metered step from an empty
        # cache of free blocks, so each allocation counts its own size
        kcommon.reset_counts(*entries())
        _free()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        with hlo.Meter() as meter:
            step(*args)
        torch.cuda.synchronize()
        grow = torch.cuda.max_memory_allocated() - m0
        launches = {fn.__name__: fn.kernel_launches for fn in entries()
                    if fn.kernel_launches}
        tally(ctx, *entries())
        # (ii) outside the kernels: FlopCounterMode over the card's step
        counter = FlopCounterMode(display=False, custom_mapping=_dtype_bmm())
        with counter:
            step(*args)
        torch.cuda.synchronize()
        card_flops = counter.get_total_flops()
        # (iv)
        times = []
        for _ in range(COST_TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    kcommon.reset_counts(*entries())
    ms = statistics.median(times)

    print(f"{label}: (i) kernel launches counted on the card {launches}, "
          f"ops in the trace {dict(trace.kernels)}, calls metered "
          f"{dict(meter.calls)}")
    check(dict(trace.kernels) == launches == dict(meter.calls),
          f"{label}: the trace's kernel ops {dict(trace.kernels)} differ "
          f"from the launches {launches}")
    print(f"{label}: (ii) FLOPs outside the kernels: trace {other_flops:.0f}"
          f", FlopCounterMode on the card {card_flops}; kernel FLOPs: trace "
          f"{k_flops:.0f}, the launches' Cost {meter.flops}")
    check(other_flops == card_flops,
          f"{label}: the trace's FLOPs outside the kernels {other_flops:.0f}"
          f" differ from FlopCounterMode's {card_flops}")
    check(k_flops == meter.flops,
          f"{label}: the trace's kernel FLOPs {k_flops:.0f} differ from the "
          f"launches' {meter.flops}")
    extra = 0
    if mode == "train":
        # the unembed's matmul_f32: each of its two cotangent products runs
        # as three bf16 products on the card, 2 x 2 x (2 B T d V) FLOPs more
        # than the function's one product each
        extra = 8 * B * T * cfg.d_model * cfg.vocab_size
        with grad:
            cpu_trace, _ = hlo.run(step, *args, device="cpu")
        more = cost["flops"] - hlo.analyze(cpu_trace.text())["flops"]
        print(f"{label}: (ii) the card's path computes {more:.0f} FLOPs more "
              f"than the function (against a trace of the CPU's path); "
              f"closed form 8 B T d V = {extra}")
        check(more == extra, f"{label}: the card's path differs from the "
                             f"function by {more:.0f} FLOPs, not {extra}")
    pred = trace.memory.high_water
    tol = COST_PEAK_REL * grow + COST_PEAK_ABS
    print(f"{label}: (iii) predicted high-water {pred} bytes, "
          f"max_memory_allocated grew {grow} over the step "
          f"({(pred - grow) / max(grow, 1):+.2%}; allowed {tol:.0f} bytes)")
    check(abs(pred - grow) <= tol,
          f"{label}: predicted peak {pred} bytes against {grow} measured")
    t_bytes = cost["bytes"] / H100.hbm_bw * 1e3
    t_ops = cost["flops"] / H100.peak_flops_bf16 * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"{label}: (iv) step {ms:.3f} ms (CUDA events, eager, median of "
          f"{[round(t, 3) for t in times]}); bound {bound_ms:.3f} ms ("
          f"{'bytes' if t_bytes >= t_ops else 'operations'}: "
          f"{cost['bytes'] / 1e9:.3f} GB, {cost['flops'] / 1e12:.3f} TFLOP)"
          f" = {bound_ms / ms:.1%} of the step")
    check(bound_ms <= COST_BOUND_SHARE * ms,
          f"{label}: the walker's bound {bound_ms:.3f} ms exceeds "
          f"{COST_BOUND_SHARE} x the step's {ms:.3f} ms")
    rec.update(trace_s=trace_s, ops=len(ops), flops=cost["flops"],
               kernel_flops=k_flops, card_flops=card_flops,
               bytes=cost["bytes"],
               transcendentals=cost["transcendental_elems"],
               launches=launches, high_water=pred, grow=grow,
               card_path_extra_flops=extra, step_ms=ms, times=times,
               bound_ms=bound_ms, bound_share=bound_ms / ms)
    del step, args, params
    return rec


def phase_summary(ctx):
    rows = []
    for name, kernel in ROWS:
        m = ctx.get(name, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES.get(kernel, kernel)}.cu",
            "replaces": KERNELS[kernel],
            "launches": ctx["launches"][name],
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms"),
            **{k: m[k] for k in ("warm_ms", "condition", "b1_ms",
                                 "b1_bound_ms", "graph_ms", "wide_ms",
                                 "wide_bound_ms", "ml_ms", "ml_base_ms",
                                 "ml_plain_ms", "ml_bound_ms",
                                 "ml_max_rel_err")
               if k in m},
        })
    ctx["kernels"] = rows
    print("kernels:")
    print(json.dumps({"kernels": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="directory for nvcc's -Xptxas -v logs and a JSON "
                         "record of this run (none by default)")
    ap.add_argument("--profile", action="store_true",
                    help="after each phase's timed rerun, run its main "
                         "path once more under torch.profiler and print the "
                         "device's busy share and time by kernel")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--mesh-worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_worker:  # one rank of the mesh phase's two-rank run
        return mesh_worker(args.mesh_worker)
    phases = [p for p in args.only.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}; allowed: {', '.join(PHASES)}")

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs the CUDA kernels and needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    ctx = {"out": args.out, "profile": args.profile,
           "launches": {name: 0 for name, _ in ROWS}}
    t0 = time.perf_counter()
    try:
        for name in phases:
            globals()[f"phase_{name}"](ctx)
    except SmokeFailure as err:
        print(f"FAILED: {err}", flush=True)
        return 1
    total = time.perf_counter() - t0
    print(f"done: phases {','.join(phases)} in {total:.1f} s")
    if args.out:
        record = {k: v for k, v in ctx.items()
                  if k not in ("out", "profile")}
        record["seconds"] = total
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
