#!/usr/bin/env python3
"""Chip smoke test of apex_tpu_torch on one NVIDIA GPU (written for an H100).

Usage: ``python3 chip_smoke.py [--profile] [--seed N]`` from the
repository root. It needs one CUDA device and exits non-zero without one. Phases, each
printing its own lines and raising on failure:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel from ``apex_tpu_torch/csrc``;
3. kernel A — LayerNorm forward vs its plain PyTorch version: serving's
              bf16 shapes, f32, and the training block's mix (bf16 x over
              fp32 w and b into bf16 y) at [8192, 768] in LayerNorm and
              RMSNorm; two runs bitwise equal; the launch plan printed;
              then fp16 x (``[kernel_a_fp16]``): amp O2's [8192, 768] with
              fp16 w and b into fp16 y (timed beside F.layer_norm in fp16),
              RMSNorm, O1's fp32 w into fp32 y, 8193 rows and h = 1020 (the
              element path), each within 1 fp16 ulp and bitwise
              repeatable, and [64, 768] with w at 2^15, where y overflows
              at the plain version's elements (masks held, not values);
4. kernel B — flash attention forward vs its plain version: the serve
              buckets, GQA and a window in bf16 and f32, then in fp16 at
              s 512 and 768, GQA, the window, kv_lengths with a 0 row,
              head_dim 128 and the T5 cross-attention shape (each timed
              beside SDPA, two runs bitwise equal);
5. kernel C — paged decode attention vs its plain version: the serve
              shape (b 8, 12 heads, positions 63-700) in bf16 and f32 on
              the vector path, GQA at head_dim 128 over 2048 rows with and
              without a window, one slot at 767, a slot at 0 and a
              sentinel inside a slot's range, head_dim 60 (the element
              path); then int8 pools, w = 4 query windows and both, at
              the serve shape (timed), GQA, the corners and head_dim 60,
              each int8 append run twice bitwise equal; two runs bitwise
              equal; the launch plan and the context's sha256 printed;
              then every case above with fp16 q (fp16 or int8 pools),
              the serve shape, int8 and w 4 timed cold with their bound;
6. kernel D — LayerNorm backward vs its plain version: GPT-2's training
              rows in bf16 over fp32 w and b, f32 and RMSNorm, the T5
              decoder's [1824, 768] RMSNorm and a bf16 width off the
              16-byte path (h = 1020); two runs bitwise equal (dx, dw, db);
              the launch plan printed; then fp16 dy and x
              (``[kernel_d_fp16]``) over fp16 and fp32 w at GPT-2's rows
              (timed beside native_layer_norm_backward in fp16), RMSNorm,
              8193 rows and h = 1020, dx within 1 fp16 ulp, and [64, 768]
              with dy at 2^12, where dx and the fp16-cast dw and db
              overflow at the plain version's elements;
7. kernel E — packed-QKV flash forward vs its plain version (GQA, RoPE,
              window, kv_lengths, and dropout whose keep mask must equal
              ``hash_keep``'s exactly, in f32 and bf16); timed beside SDPA
              at the GPT-2 and the T5 encoder and decoder shapes, where
              two bf16 runs must be bitwise equal; in fp16 at the GPT-2
              shape (timed beside SDPA in fp16, bitwise repeatable), GQA,
              RoPE, a window, kv_lengths with a 0, dropout and s 1000;
8. kernel F — packed-QKV flash backward vs its plain version (f32 atol
              1e-4; bf16, where both round ds and the dropped p as the JAX
              kernel does, 1 ulp plus one bf16 step of each rounded factor,
              at most 0.1% of the elements past 1 ulp); timed beside SDPA's
              backward at the GPT-2 shape, where two bf16 runs must be
              bitwise equal, and the f32 dqkv's sha256 printed; fp16 in
              the same cases as E (1 fp16 ulp plus one fp16 step of each
              rounded factor, at most 0.8% past 1 ulp); then the fp16
              overflow cases of E (v at
              2^14 under dropout 0.5) and F (do at 2^12, v at 2^6), whose
              non-finite elements must be the plain versions';
9. serve    — GPT-2 124M (bf16, random weights from a seed) serves 16
              greedy requests through ``InferenceEngine``; the launch
              counters of its kernels (A, B, C), read over this phase
              alone, must be > 0;
    serve_prefix, serve_int8, serve_spec — the same model at the same
              engine size serves 16 greedy requests with one feature on:
              the prefix cache over a shared 512-token prompt prefix with
              suffixes of 16-200 tokens (>= 15 hits; Kernel B launched
              only for the misses' prefills), ``kv_dtype="int8"``, and
              ``speculation=4``; each ends every request ``length``/``eos``
              with Kernel C launched exactly decode steps x 12 layers;
    serve_sampled, serve_chunked, serve_flat, serve_supervised — the same
              model and engine size serve the ``[serve]`` requests through
              the engine's other paths: half of them sampled (temperatures
              0.7 and 1.0, top_k None and 8, seeds from ``--seed``; C
              launched decode steps x 12, B 12 a prefill; the device
              operations of one 8-slot decode tick, greedy and sampled, and
              of the sampling alone, counted by torch.profiler),
              ``prefill_token_budget=256`` (every chunk runs the
              suffix-prefill program: B launched 0 times, C decode steps x
              12; the chunk counts), ``kv_layout="flat"`` (C 0, B 12 a
              prefill), and an ``EngineSupervisor`` whose fault injector
              raises once in decode and once in prefill (two restarts);
              every request ends ``length``/``eos``;
    serve_fp16 — the ``[serve]`` requests on GPT-2 124M in fp16 (fp16
              weights from the seed, fp16 pools): every request ends
              ``length``/``eos``, C launched decode steps x 12, B 12 a
              prefill, A > 0, every other kernel 0; then
              ``[serve_fp16_pairs]``, the bf16 and fp16 models serving in
              turns (bf16, fp16, fp16, bf16): tokens/s, TTFT p50, decode
              ms a step;
10. card vs CPU — one f32 request gives the same greedy tokens on the card
              as the plain path on the CPU; then a small f32 GPT serves
              shared-prefix requests with the prefix cache, int8 pools and
              speculation (3), each with the same tokens on both; then,
              half of them sampled, through sampled paged decode, sampled
              speculation (3), chunked prefill paged and flat, a priority
              preemption whose continuation the supervisor resubmits, and
              a supervisor restart after injected failures, each with the
              same tokens on both; then a small fp16 GPT teacher-forced on
              the CPU's greedy tokens on the paged and the flat layout
              (prefill and 8 decode steps): the card's logits within
              ``SERVE_FP16_LOGIT_ULPS`` fp16 ulps of the row's largest,
              the argmax equal wherever the CPU's top-two margin is
              clear of that;
11. train   — GPT-2 124M in the ``bench.py`` configuration (bf16 compute,
              fp32 params, b 8, s 1024, FusedAdam lr 1e-4) takes 2 + 8
              steps of ``make_train_step`` on a fixed seeded batch; every
              loss finite, the last below the first, and Kernels A, D, E,
              F launched exactly 25, 25, 12 and 12 times a step, the Adam
              kernel the launches its list implies; then the device
              operations and ms of one optimizer step through the kernels
              and through the per-parameter torch ops (``[optimizer]``; the
              bert, t5 and rn50 phases print the same);
12. train card vs CPU — a small f32 GPT (TF32 off) trains 3 steps on the
              card and on the CPU from the same seed: losses and every
              step-1 gradient leaf agree;
13. kernel G/H — the masked softmax forward and backward vs their plain
              versions in f32, bf16 and fp16: BERT's [16,1,512,512]
              padding mask with fully masked rows (which must be 1/k), a
              [b,1,1,s] key mask, causal [96,1024,1024], rows of 17, 1000
              and 4097, scale != 1 (BERT's timed in bf16 and fp16); then
              H in fp16 with dy at 2^14 and scale 8, non-finite at the
              plain version's elements;
14. kernel I — the 4D flash backward vs its plain version in f32, bf16
              and fp16: the T5 cross-attention shape with kv_lengths,
              causal GQA at 1024, window 256, a kv_lengths row at 0, causal
              sq != sk; two runs bitwise equal, the outputs' sha256
              printed; Kernel B at each shape; the T5 cross-attention
              timed in bf16 and fp16; then fp16 with do at 2^12 and v at
              2^6 (``[kernel_i_fp16_overflow]``), non-finite at the plain
              version's elements;
15. bert_train — BERT-base (b 16, s 512, seeded padding masks, tokentype
              ids, FusedLAMB lr 1e-3 wd 0.01) takes 2 + 8 steps; every loss
              finite, the last below the first, and the launches a step of
              every kernel as the model's code implies (LN 26/26, softmax
              12/12, the flash kernels 0, LAMB's l2norm and LAMB kernels
              as its list implies);
    bert_train_fp16 — the same BERT-base under amp O2 in fp16
              (FusedLAMB over fp32 masters, dynamic scale from 2^16, an
              inf injected at step 5): LN 26/26, softmax 12/12 in fp16, the
              flash kernels 0, unscale, LAMB and its norms as the lists
              imply; every skipped step bitwise unchanged, the loss falls;
16. t5_train — an encoder-decoder at T5-base widths (12 + 12 layers,
              RMSNorm, ReLU, inputs 512 with seeded enc_lengths, targets
              114, b 16, FusedAdam lr 1e-4), the same checks (LN 62/62,
              packed 24/24, flash 12/12, softmax 0);
    t5_train_fp16 — the same model and batch under amp O2 in fp16 (fp16
              params, FusedAdam over fp32 masters, dynamic scale from
              2^16, an inf injected at step 5): A, D, E, F, B and I in fp16
              (LN 62/62, packed 24/24, flash 12/12 a step), unscale and
              Adam as the lists imply; every skipped step bitwise
              unchanged, the loss falls;
17. enc card vs CPU — a small f32 BERT with a padding mask and LAMB, and a
              small encoder-decoder with enc_lengths, train 3 steps on the
              card and on the CPU: losses and every step-1 gradient leaf
              agree;
18. kernel J/K — the fused 1x1 conv forward and backward vs their plain
              versions, f32, bf16 and fp16, with a random stats cotangent:
              ResNet-50's layer1 conv3 (affine + relu), layer4 conv1 and
              downsample (no affine; the downsample's 2M weights were
              gated off the TPU), and a 200-row tail in every (affine,
              relu) combination; two forward and two backward runs
              bitwise equal; the outputs' sha256 printed; layer1 timed in
              bf16 and fp16;
19. kernel L/M — the fused 3x3 conv forward and backward, the same checks
              at ResNet-50's four stride-1 3x3 shapes [256,56,56,64],
              [256,28,28,128], [256,14,14,256], [256,7,7,512] (the first
              and last gated off the TPU), an odd [3,5,9,16] -> 32 and a
              ragged [5,13,11,20] -> 36 (channels off L's and M's
              8-channel copies, pixels off their 128-pixel tiles); then K
              and M in fp16 with dy at 2^13 and ds1 at 2^14, where dy_eff
              overflows (``[kernel_k_fp16_overflow]``,
              ``[kernel_m_fp16_overflow]``): non-finite at the plain
              versions' elements;
20. rn50_train — ResNet-50 (224 px, batch 256, bf16 compute over fp32
              params, fused_conv, FusedSGD lr 0.1 momentum 0.9 wd 1e-4 with
              master weights) takes 2 + 8 steps; every loss finite, the
              last below the first, and Kernels J, K, L, M launched exactly
              36, 36, 13 and 13 times a step, the SGD kernel as its list
              implies, every other kernel 0;
    rn50_train_fp16 — the same with ``compute_dtype=torch.float16`` under
              amp O2's dynamic scale (fp32 params and masters, an inf
              injected at step 5): J, K, L, M in fp16 (36/36/13/13 a
              step), SGD and unscale as the lists imply; every skipped step
              bitwise unchanged, the loss falls;
21. rn50 card vs CPU — ResNet-50 at 64 px, batch 4, 8 classes, f32:
              two fused blocks alone (layer1.1 and layer2.0: output, input
              and parameter gradients, new batch-norm state to 2e-5 of each
              leaf's largest magnitude), which with the checks of phases 18
              and 19 decide Kernels K and M; then, as a check of the
              model's wiring, the step-1 loss, every gradient leaf and the
              batch-norm state
              with ``zero_init_residual=False`` (gradients held to the
              noise floor that 1e-7 perturbations of the input show on the
              CPU), then three FusedSGD steps with the recipe's init;
              then in fp16: the two blocks, each leaf at most twice as far
              from the CPU's f32 block as the CPU's fp16 block is, and
              three steps under amp O2's dynamic scale (an inf at step 1):
              scaler walks equal, losses within ``AMP_FP16_LOSS_RTOL``;
22. multi_tensor — the five multi-tensor kernels (amp's unscale, the L2
              norms, Adam, LAMB, SGD; port-only, csrc/multi_tensor.cu) over
              GPT-2 124M's 148 parameters plus a 1-element tensor and one
              of CHUNK + 1, with fp32 params and with bf16 params over fp32
              masters, SGD also over ResNet-50's 161 and LAMB over
              BERT-base's, each against its plain version on the card over
              3 steps: scale, Adam and SGD bitwise, the norms within 1e-6
              (summation order; two runs bitwise equal), LAMB every state
              leaf within 1e-6 norm-wise; a found_inf step leaves every
              param, master, slot and step bitwise unchanged; timed beside
              the plain per-parameter loop and the library's call;
23. train_amp — GPT-2 124M at the train shape under amp O2 (bf16 params,
              FusedAdam over fp32 masters, dynamic scale 2**16): scale_loss
              -> backward -> unscale -> step(found_inf) -> update, 2 + 8
              steps; an inf written into one grad at one step must skip
              that step bitwise and halve the scale, every other step
              finds no inf, the loss falls, and every kernel launches
              exactly what the step implies;
    train_fp16 — the same with ``half_dtype=torch.float16``: fp16 params
              and compute through Kernels A, D, E and F in fp16 (LN 25/25,
              packed 12/12, unscale 4 and Adam 5 launches a step, every
              other kernel 0); the injected inf skips its step bitwise and
              halves the scale, natural overflows are allowed but each is
              reported by step and must skip bitwise too, at least one
              step applies and the loss falls;
24. amp card vs CPU — a small f32 GPT runs the amp flow (O2 over f32,
              fp32 masters, dynamic scale, an inf at step 2) 5 steps with
              FusedAdam, FusedLAMB and FusedSGD on the card and the CPU:
              the losses, scaler states and parameters agree; then the
              same GPT under O2 in fp16 with FusedAdam, a small BERT with
              a padding mask under O2 in fp16 with FusedLAMB, and a small
              encoder-decoder with enc_lengths under O2 in fp16 with
              FusedAdam: scaler states equal, losses within
              ``AMP_FP16_LOSS_RTOL``;
25. flash_hd256 — Kernels E, F, B and I past head_dim 128 against their
              plain versions in f32, bf16 and fp16 (E and B o within 1
              ulp, F and I 1 ulp plus the rounding slack, at most 0.1% /
              0.8% past 1 ulp; 16-bit runs bitwise repeatable, sha256
              printed): E and F at Gemma-2B's training shape (qkv [1024,
              2, 2560], 8 query heads of 256 over one K/V head, causal,
              RoPE over 256; timed beside SDPA), with a window, kv_lengths
              with a 0 row and dropout, and at head_dim 160; B and I at q
              [2, 8, 2048, 256] over one K/V head, causal (timed beside
              SDPA; driven once through ``flash_attention``'s autograd,
              the main path of I at 256, ``[flash_hd256_autograd]``), and
              at head_dim 160, 200 and 196 (the element-by-element
              copies); Kernel C's d-256 cases (8 query heads over one K/V
              head; int8 pools, a w = 4 window) run in phase 5;
26. gemma2b_train — a GPT at Gemma-2B's widths and 18 layers (hidden
              2048, 8 query heads of 256 over one K/V head, geglu 16384,
              RMSNorm, RoPE, vocab 256000; bf16 over fp32 params, weights
              from a seed, the init's seconds printed) takes 2 + 8 steps at
              b 2 x 1024 with FusedAdam: the loss falls and Kernels A, D,
              E and F launch 37, 37, 18 and 18 times a step, B and I 0;
    gemma2b_serve — the same model, its optimizer state dropped, serves 8
              greedy requests in bf16 (prompts 64-700, 32 new tokens, 8
              slots of 768, pages of 64): every request ends
              ``length``/``eos``, A > 0, B 18 a prefill and C 18 a decode
              step at head_dim 256, every other kernel 0;
27. hd256 card vs CPU — a tiny f32 GPT at head_dim 256 (2 layers, hidden
              512, 2 query heads over one K/V head, geglu, RMSNorm, RoPE)
              trains 3 steps on the card and the CPU (losses and
              gradients as phase 12) and serves 3 greedy requests on both
              with the same tokens.
28. layer_norm_wide — Kernels A and D past their element kernels' shared
              memory (A's wide path past h 14336, D's past 29056) against
              their plain versions: h 16384, 18432, 32768 and 16388 (off
              8), 8 and 2048 rows, f32, bf16 and fp16 (fp16 w and b beside
              fp16 x, fp32 beside the others), LayerNorm and RMSNorm, to
              ``[layer_norm]``'s bars, two runs bitwise equal (dx, dw, db
              too), the paths printed; then A and D timed, warm and cold,
              at the 405B decode step's [8, 16384] RMSNorm and at 2048
              rows of 16384 and 32768 beside ``F.layer_norm`` /
              ``F.rms_norm`` / ``native_layer_norm_backward``;
29. llama405b_serve — the repo's GPT blocks at Llama-3.1-405B's widths
              (hidden 16384, 128 query heads of 128 over 8 K/V heads,
              SwiGLU 53248, RMSNorm, RoPE theta 500000, vocab 128256),
              depth cut to 2 layers, bf16 weights drawn on the card from a
              seed, serve 8 greedy requests through ``[serve]``'s engine:
              every request ends ``length``/``eos``; A launches 5 a
              forward (the wide path), B 2 a prefill (GQA 16:1), C 2 a
              decode step (its plan cuts the group of 16 into two chunks),
              every other kernel 0; tokens/s, TTFT p50, decode ms a step,
              peak GB, init s, the card's name and power limit;
30. wide card vs CPU — one layer at hidden 16384 (128 heads over 8
              groups, ffn 1024, vocab 512, f32, TF32 off) serves 3 greedy
              requests on the card and the CPU (the same tokens), then
              trains 3 steps on each (phase 12's bar);
31. train_features — GPT-2 124M at ``[train]``'s shapes with GPT-2's
              dropout (0.1 on the embedding, the residuals and the
              attention: E's and F's hash dropout) takes 2 + 8 steps alone,
              with ``recompute`` full and selective (A and E launched
              again for each layer: 49 and 24 a step) and with
              ``loss_seq_chunks=4``: the loss falls and every kernel
              launches what a step implies; then one threefry mask over
              [1024, 8, 768] timed;
32. train_features card vs CPU — a small f32 GPT (Adam) and BERT
              (padding mask, LAMB) with dropout 0.1 under no recompute,
              ``recompute`` True, full and selective, and (GPT)
              ``loss_seq_chunks=2``: three steps on the card and the CPU
              (phase 12's bar); each recompute mode's step-1 gradients on
              the card bitwise those without recompute (a leaf that two
              runs without recompute do not repeat bitwise is named and
              left out); ``bernoulli`` masks and the attention seeds
              bitwise the CPU's;
33. flash_hd512 — Kernels E, F, B and I past head_dim 256 (DMAX 512)
              against their plain versions in f32, bf16 and fp16 (phase
              25's bars, the backwards' 1-ulp magnitude floor scaled by d /
              256: ``ops.attention.backward_floor``): E and F at HD512's training shape
              (qkv [1024, 2, 6144], 8 query heads of 512 over 2 K/V heads,
              causal, RoPE over 512; timed beside SDPA, its backend named),
              MQA 8:1 with a window and dropout, d 384 (half the columns
              rotated, a 0 length), 320 (GQA 4:1, dropout), 392 (a window)
              and 260 (the element copies); B and I at q [2, 8, 1024, 512]
              over 2 K/V heads (timed; driven once through
              ``flash_attention``'s autograd, ``[flash_hd512_autograd]``),
              MQA with a 0 length, d 384 (a window), 320 (sq < sk), 392
              (sq > sk) and 260;
34. kernel_c (hd512) — Kernel C at HD512's decode (b 8, 8 query heads
              over 2 K/V heads, head_dim 512, pages of 64) on the vector
              path, two 16-byte pieces a lane in bf16 and fp16 (four in
              f32), over int8 pools and with a w = 4 window, then f32 q
              over int8 pools on the element path (32-row tiles at pages
              of 64 and 128) and head_dim 260 in bf16 and fp16 (the
              element path, whole pages); bf16 timed cold beside its
              plain version and bound;
35. hd512_train — a GPT at HD512 (Llama-2-7B's widths with 8 query heads
              of 512 over 2 K/V heads, SwiGLU 11008, RMSNorm, RoPE, vocab
              32000; 32 layers cut to 4; bf16 over fp32 params, weights
              from a seed) takes 2 + 8 steps at b 2 x 1024 with FusedAdam:
              the loss falls and Kernels A, D, E and F launch 9, 9, 4 and
              4 times a step, B and I 0;
    hd512_serve — the same model serves 8 greedy requests in bf16 (pages
              of 64): every request ends ``length``/``eos``, A > 0, B 4 a
              prefill (GQA 4:1 at head_dim 512), C 4 a decode step on its
              vector path (plan printed), every other kernel 0;
36. hd512 card vs CPU — a tiny f32 GPT with 512-wide heads (2 layers,
              hidden 1024, 2 query heads over one K/V head) trains 3 steps
              on the card and the CPU (phase 12's bar) and serves 3 greedy
              requests with pages of 64 on both with the same tokens;
37. flash_chunk — Kernels B and I at global offsets, launched through
              ``flash_chunk_fwd`` / ``flash_chunk_bwd`` (the backward on a
              given lse and delta) against their plain chunk versions at
              every corner of ``CHUNK_CASES`` (before, on and straddling
              the diagonal, wholly in the future, a far past that a window
              cuts and one it skips, global kv_lengths ending inside,
              before and after the chunk, positions past 12288, GQA, head
              dims 64 to 512) in f32, bf16 and fp16: o f32 atol 2e-5 or 1
              ulp, lse 1e-4, grads phase 25's bars; a chunk that sees no
              key gives lse 1e30 and zeros; two runs bitwise equal; B and
              I launched twice a case, every other kernel 0;
38. ring    — a 4-chunk ring at Mistral-7B's attention widths (32 query
              heads over 8 K/V heads, head_dim 128, window 4096; s 16384
              in chunks of 4096, b 2, global kv_lengths 16384 and 10000,
              causal), all four ranks on the card
              (``_ring_attention_local``), forward and backward under
              autograd: B and I launched 16 times each, every other kernel
              0; f32 held to the non-ring ``flash_attention`` (o 2e-5,
              every grad element within 1e-5 of its grad's largest
              |value|) and, on one K/V head group, to exact float64
              attention (``_ring_exact_check``), bf16 to the same
              schedule over the plain chunk versions
              (``ring_vs_plain_ring``'s derived bars); then, in bf16, the
              ring's forward and backward timed beside the non-ring flash
              and each kind of chunk call alone (diagonal, window-cut,
              far past, future), with the card's name and power limit.

Then one JSON line of per-kernel numbers (launches from the phase that
drives each kernel's slice: serve for A-C, serve_int8 and serve_spec for
C's int8 and window records, train for D-F, bert_train for G and H,
t5_train for I, rn50_train for J-M and SGD, train_amp for the unscale
and Adam kernels, bert_train for LAMB and the norms, train_fp16 for the
fp16 records of A, D, E and F, serve_fp16 for those of B and C,
bert_train_fp16 for those of G and H, t5_train_fp16 for I's,
rn50_train_fp16 for J-M's, gemma2b_train for E's and F's head_dim-256
records, gemma2b_serve for B's and C's, flash_hd256 for I's,
llama405b_serve for A's wide-row record, hd512_train for E's and F's
head_dim-512 records, hd512_serve for B's and C's, flash_hd512 for I's,
ring for B's and I's offset records (``flash_fwd_ring``,
``flash_bwd_ring``: the diagonal chunk call), with every path's counts in ``launches_by_path``;
times from CUDA events in this run; ``bound_ms`` from this run's shapes
over the H100's published peaks), and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
L2_BYTES = 50 * 2 ** 20
SPIN_CYCLES = 200_000_000          # ~0.1 s at the H100's ~2 GHz
#: kernels listed by name in a ``--profile`` breakdown (the rest summed)
PROFILE_TOP = 40

GPT2 = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
            vocab_size=50304, max_position_embeddings=1024)
PROMPT_LENS = (64, 128, 256, 512, 700)
SERVE_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_decode")
#: launches a GPT-2 124M training step must make (2 LN per layer + final)
TRAIN_KERNELS = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                 "flash_packed_fwd": 12, "flash_packed_bwd": 12}
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 8
#: every kernel's launch counter
ALL_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd",
               "flash_packed_fwd", "flash_packed_bwd", "paged_decode",
               "softmax_fwd", "softmax_bwd", "conv1x1_fwd", "conv1x1_bwd",
               "conv3x3_fwd", "conv3x3_bwd", "multi_tensor_scale",
               "multi_tensor_l2norm", "multi_tensor_adam", "multi_tensor_lamb",
               "multi_tensor_sgd")
#: BERT-base (benchmarks/bert_lamb.py:20-27) and its launches a step: 2 LN
#: per layer, the final LN and the LM head's; one masked softmax per layer
BERT = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
            vocab_size=30528, max_position_embeddings=512)
BERT_BATCH, BERT_SEQ = 16, 512
BERT_KERNELS = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                "softmax_fwd": 12, "softmax_bwd": 12}
#: T5-base widths (the public t5-base config) with the JAX model's learned
#: positions and biases; encoder 2 norms a layer + final, decoder 3 + final;
#: packed self-attention in both stacks, 4D flash in cross-attention
T5 = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
          ffn_hidden_size=3072, activation="relu", normalization="rmsnorm",
          vocab_size=32128, max_position_embeddings=512)
T5_BATCH, T5_ENC, T5_DEC = 16, 512, 114
T5_KERNELS = {"layer_norm_fwd": 62, "layer_norm_bwd": 62,
              "flash_packed_fwd": 24, "flash_packed_bwd": 24,
              "flash_fwd": 12, "flash_bwd": 12}
#: ResNet-50 as benchmarks/rn50_dp.py:21-31 trains it, on the fused path:
#: 16 bottlenecks run conv1 and conv3 through the 1x1 kernels and the 4
#: downsamples add 4; the 13 stride-1 conv2s take the 3x3 kernels (the 3
#: stride-2 ones keep cuDNN's conv)
RN50_BATCH, RN50_SIZE = 256, 224
RN50_KERNELS = {"conv1x1_fwd": 36, "conv1x1_bwd": 36, "conv3x3_fwd": 13,
                "conv3x3_bwd": 13}
#: Gemma-2B's widths (google/gemma-2b config.json: hidden 2048, 8 query
#: heads of 256 over one K/V head, a gated GELU MLP of 16384, 18 layers,
#: vocab 256000, RMSNorm eps 1e-6, RoPE theta 10000, 8192 positions) on the
#: repo's GPT blocks (its biases, plain RMSNorm weight and exact GELU);
#: launches a training step: 2 RMSNorms a layer + final, one packed
#: attention a layer (head_dim 256 takes Kernels E and F)
GEMMA = dict(num_layers=18, hidden_size=2048, num_attention_heads=8,
             num_query_groups=1, ffn_hidden_size=16384, activation="geglu",
             normalization="rmsnorm", position_embedding_type="rope",
             rope_theta=10000.0, layernorm_epsilon=1e-6, vocab_size=256000,
             max_position_embeddings=8192)
GEMMA_BATCH, GEMMA_SEQ = 2, 1024
GEMMA_KERNELS = {"layer_norm_fwd": 37, "layer_norm_bwd": 37,
                 "flash_packed_fwd": 18, "flash_packed_bwd": 18}
#: the tiny head_dim-256 GPT of tests/test_torch_hd256.py (2 query heads
#: of 256 over one K/V head, geglu, RMSNorm, RoPE)
HD256_SMALL = dict(num_layers=2, hidden_size=512, num_attention_heads=2,
                   num_query_groups=1, activation="geglu",
                   normalization="rmsnorm", position_embedding_type="rope",
                   vocab_size=128, max_position_embeddings=128,
                   hidden_dropout=0.0, attention_dropout=0.0)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of one call, from CUDA events around each call.
    A spin kernel queued first keeps the card busy while the host enqueues
    every call, so the events time the device work and not the host's
    launch overhead. With ``cold`` the L2 is flushed before every call
    (the caller would find its operands in device memory)."""

    def __init__(self):
        self._flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                  device="cuda")

    def __call__(self, fn, *, iters=30, warmup=3, cold=False) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            if cold:
                self._flush.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        return times[len(times) // 2]


#: fraction bits of the 16-bit types (the ulp at 1 is 2^-bits)
FRACTION_BITS = {torch.bfloat16: 7, torch.float16: 10}


def ulps16(got: torch.Tensor, want: torch.Tensor,
           floor: float = 2.0 ** -8) -> float:
    """Largest |got - want| over the elements finite on both sides, in
    units of the ulp of ``got``'s 16-bit type (bf16 or fp16) at the larger
    of the two, that magnitude floored at ``floor`` (2^-8): where ``x_hat
    * w + b`` cancels to near zero, an fp32 rounding difference (a fused
    multiply-add against a separate multiply and add) is larger than the
    ulp of the tiny result."""
    g, w = got.float(), want.float()
    fin = torch.isfinite(g) & torch.isfinite(w)
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag))
                     - FRACTION_BITS[got.dtype])
    err = ((g - w).abs() / ulp)[fin]
    return float(err.max()) if err.numel() else 0.0


def same_nonfinite(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Both sides non-finite (an fp16 overflow) at the same elements."""
    return torch.equal(torch.isfinite(got), torch.isfinite(want))


def check_close(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """A kernel's output against its plain version's: both compute in
    fp32 and round once to the output dtype (the plain version is run on
    the inputs cast to fp32), so bf16 and fp16 may differ by one rounding
    step, 1 ulp of that type, and must overflow to inf at the same
    elements; f32 by summation order only, atol 1e-4."""
    if got.dtype in FRACTION_BITS:
        ulps = ulps16(got, want)
        name = "bf16" if got.dtype == torch.bfloat16 else "fp16"
        return (ulps, ulps <= 1.0 and same_nonfinite(got, want),
                f"1 {name} ulp")
    return 0.0, float((got - want).abs().max()) <= 1e-4, "atol 1e-4"


def check_rounded_factors(got: torch.Tensor, want: torch.Tensor,
                          slack: torch.Tensor,
                          floor: float = 2.0 ** -8) -> tuple:
    """A bf16 or fp16 flash backward that rounds ds and p to that type
    where the JAX kernels do, against its plain version on the same
    inputs: every element within 1 ulp plus ``slack``, one rounding step of
    each rounded factor carried to the output (two fp32 summation orders
    may round a ds on a rounding boundary to neighbouring values), and at
    most a small share of the elements past 1 ulp: 0.1% in bf16, 0.8% in
    fp16 (against the same fp32 differences, fp16's 2^3 times finer
    spacing puts 2^3 times as many ds on a boundary); one ulp is 2^-7
    (bf16) or 2^-10 (fp16) of the magnitude, floored at the magnitude
    ``floor`` (2^-8; ``ops.attention.backward_floor`` past head_dim 256).
    Returns (max abs err, ulps, share past 1 ulp, the largest share of its
    bound an element's error takes (past 1 where it fails), ok)."""
    e = (got.float() - want.float()).abs()
    bits = FRACTION_BITS[got.dtype]
    eps = 2.0 ** -bits
    one = floor * eps + eps * want.float().abs()
    past = float((e > one).float().mean())
    ok = bool((e <= one + slack).all()) and past <= 1e-3 * 2.0 ** (bits - 7)
    return (float(e.max()), ulps16(got, want), past,
            float((e / (one + slack)).max()), ok)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes: equal digests from two versions of a
    kernel on the same seeded inputs mean bitwise equal outputs."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    print(_card_name(), flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build() -> None:
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds:.2f}",
        sources=len(_build._sources()))


def _plan_text(plan) -> str:
    """A LayerNorm kernel's launch plan as one log field."""
    return (f"{plan.path}:pieces{plan.pieces}:rows_a_warp{plan.rows_a_warp}"
            f":blocks{plan.blocks}")


#: (rows, x dtype, w/b dtype, RMSNorm): [8, 768] every decode step (2 per
#: layer + final); [768, 768] the largest prefill bucket; [8*768, 768] a
#: bulk shape (all with w, b and y in x's dtype, as serving runs them);
#: then the training block's mix, bf16 x over fp32 w and b into bf16 y
#: ([8192, 768]: GPT-2's and BERT's rows), LayerNorm and RMSNorm (T5)
LN_FWD_CASES = [(8, torch.bfloat16, torch.bfloat16, False),
                (768, torch.bfloat16, torch.bfloat16, False),
                (8 * 768, torch.bfloat16, torch.bfloat16, False),
                (8 * 768, torch.float32, torch.float32, False),
                (8192, torch.bfloat16, torch.float32, False),
                (8192, torch.bfloat16, torch.float32, True)]


def phase_layer_norm(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd_cuda,
                                               layer_norm_fwd_cuda_plan,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    h = GPT2["hidden_size"]
    w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
    b = 0.1 * torch.randn(h, device="cuda", generator=g)
    record = None
    for rows, dtype, wdt, is_rms in LN_FWD_CASES:
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        wd, bd = w.to(wdt), None if is_rms else b.to(wdt)
        run = lambda: layer_norm_fwd_cuda(x, wd, bd, 1e-5, is_rms,  # noqa
                                          dtype)
        y, mean, iv = run()
        again = run()
        ry, rmean, riv = layer_norm_fwd_plain(x.float(), wd, bd, 1e-5,
                                              is_rms, torch.float32)
        ry = ry.to(dtype)
        torch.cuda.synchronize()
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((iv - riv).abs().max()))
        ulps, ok, tol = check_close(y, ry)
        same = all(torch.equal(u, v) for u, v in zip((y, mean, iv), again))
        if not ok or stat_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_fwd [{rows},{h}] {dtype} w {wdt} rms={is_rms}: "
                f"max err {err} ({ulps} ulp), stats err {stat_err} — "
                f"tolerance {tol}, stats 1e-4; two runs bitwise equal: "
                f"{same}")
        esz = x.element_size()
        n_bytes = 2 * rows * h * esz + (1 if is_rms else 2) * h * \
            wd.element_size() + 2 * rows * 4
        bms, by = bound_ms(n_bytes, 8.0 * rows * h, dtype)
        ms = timer(run)
        plain = timer(lambda: layer_norm_fwd_plain(x, wd, bd, 1e-5, is_rms,
                                                   dtype))
        # the library call with w and b in x's dtype (F.rms_norm where
        # the installed PyTorch has it)
        lib = None
        if not is_rms:
            lib = timer(lambda: F.layer_norm(x, (h,), wd.to(dtype),
                                             bd.to(dtype), 1e-5))
        elif hasattr(F, "rms_norm"):
            lib = timer(lambda: F.rms_norm(x, (h,), wd.to(dtype), 1e-5))
        log("kernel_a", shape=f"[{rows},{h}]", dtype=str(dtype)[6:],
            w=str(wdt)[6:], rms=is_rms,
            plan=_plan_text(layer_norm_fwd_cuda_plan(x, y, wd, bd)),
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            repeat_bitwise=same, ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by)
        if (rows, dtype, wdt, is_rms) == (8, torch.bfloat16, torch.bfloat16,
                                          False):
            record = dict(name="layer_norm_fwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_fwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:50",
                          shape=f"x[{rows},{h}] bf16 affine+bias",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


#: fp16 rows of Kernel A (rows, h, w dtype, y dtype, RMSNorm): amp O2's
#: GPT-2 rows with fp16 w and b into fp16 y (the timed record, beside
#: F.layer_norm in fp16), RMSNorm, O1's fp32 w and b with y promoted to
#: fp32, a ragged tail (a row past the grid), and a width off the 16-byte
#: path (h = 1020: the element kernel)
LN_FWD_FP16_CASES = [
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float16, torch.float16, False),
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float16, torch.float16, True),
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float32, torch.float32, False),
    (TRAIN_BATCH * TRAIN_SEQ + 1, 768, torch.float16, torch.float16, False),
    (2048, 1020, torch.float16, torch.float16, False),
]


def _fp16_overflow(phase, got, want, **fields) -> None:
    """An fp16 output scaled past 65504: non-finite at the same elements
    as the plain version's, and some must be. Only the masks are held:
    the scale that forces the overflow also multiplies the fp32 noise of
    the two summation orders (the row statistics, the sums over rows) far
    past the ulp of a result near zero, so the values are held where the
    scale is well inside the range (the phases' other cases)."""
    same = same_nonfinite(got, want)
    nonfinite = int((~torch.isfinite(got)).sum())
    log(phase, **fields, nonfinite=nonfinite, elements=got.numel(),
        same_nonfinite=same)
    if not same or nonfinite == 0:
        raise AssertionError(f"{phase}: {nonfinite} non-finite, masks equal "
                             f"{same}")


def phase_layer_norm_fp16(timer: Timer) -> dict:
    """Kernel A on fp16 x: each case within 1 fp16 ulp of the plain
    version run in fp32 and rounded once, mean and invvar within 1e-4, two
    runs bitwise equal, the plan printed; then [64, 768] with w at 2^15,
    where y overflows at the plain version's elements."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd_cuda,
                                               layer_norm_fwd_cuda_plan,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(11)
    record = None
    for rows, h, wdt, ydt, is_rms in LN_FWD_FP16_CASES:
        w = (1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)).to(wdt)
        b = None if is_rms else \
            (0.1 * torch.randn(h, device="cuda", generator=g)).to(wdt)
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).half()
        run = lambda: layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms,  # noqa
                                          ydt)
        y, mean, iv = run()
        again = run()
        ry, rmean, riv = layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                              torch.float32)
        ry = ry.to(ydt)
        torch.cuda.synchronize()
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((iv - riv).abs().max()))
        ulps, ok, tol = check_close(y, ry)
        same = all(torch.equal(u, v) for u, v in zip((y, mean, iv), again))
        if not ok or stat_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_fwd fp16 [{rows},{h}] w {wdt} y {ydt} "
                f"rms={is_rms}: max err {err} ({ulps} ulp), stats err "
                f"{stat_err} — tolerance {tol}, stats 1e-4; two runs "
                f"bitwise equal: {same}")
        fields = {}
        if record is None:
            n_bytes = rows * h * (2 + y.element_size()) + \
                (1 if is_rms else 2) * h * w.element_size() + 2 * rows * 4
            bms, by = bound_ms(n_bytes, 8.0 * rows * h, torch.float16)
            ms = timer(run)
            plain = timer(lambda: layer_norm_fwd_plain(x, w, b, 1e-5, is_rms,
                                                       ydt))
            lib = timer(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
            fields = dict(ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
                          library_ms=f"{lib:.5f}", bound_ms=f"{bms:.5f}",
                          bound_by=by)
            record = dict(name="layer_norm_fwd_fp16", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_fwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:50",
                          shape=f"x[{rows},{h}] fp16, w,b fp16, y fp16",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
        log("kernel_a_fp16", shape=f"[{rows},{h}]", w=str(wdt)[6:],
            y=str(ydt)[6:], rms=is_rms,
            plan=_plan_text(layer_norm_fwd_cuda_plan(x, y, w, b)),
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            repeat_bitwise=same, y_sha256=digest(y), **fields)
    h = 768
    x = (2.0 * torch.randn(64, h, device="cuda", generator=g) + 0.5).half()
    w = torch.full((h,), 2.0 ** 15, device="cuda").half()
    b = (0.1 * torch.randn(h, device="cuda", generator=g)).half()
    y, _, _ = layer_norm_fwd_cuda(x, w, b, 1e-5, False, torch.float16)
    ry = layer_norm_fwd_plain(x.float(), w, b, 1e-5, False,
                              torch.float32)[0].half()
    _fp16_overflow("kernel_a_fp16_overflow", y, ry, shape=f"[64,{h}]",
                   w="2^15")
    return record


def _visible_spans(sq, sk, causal, window, kv_len):
    """The ``[lo, hi)`` keys each query row of one batch row sees."""
    off = sk - sq
    for r in range(sq):
        hi = min(kv_len, r + off + 1) if causal else min(kv_len, sk)
        lo = max(0, r + off - window + 1) if window else 0
        yield lo, hi


def _visible_pairs(sq, sk, causal, window, kv_len):
    return sum(max(0, hi - lo)
               for lo, hi in _visible_spans(sq, sk, causal, window, kv_len))


def _visible_rows_keys(sq, sk, causal, window, kv_len) -> tuple:
    """``(query rows that see a key, keys that some query row sees)`` of
    one batch row: the q and K/V rows the backward must read. Both span
    ends grow with the row, so the keys seen are a union of intervals."""
    rows = keys = end = 0
    for lo, hi in _visible_spans(sq, sk, causal, window, kv_len):
        if hi > lo:
            rows += 1
            keys += max(0, hi - max(lo, end))
            end = max(end, hi)
    return rows, keys


def phase_flash(timer: Timer) -> list:
    """Kernel B against its plain version run in f32 and rounded once (1
    ulp of the 16-bit type, f32 atol 1e-4) at the serve buckets, GQA, a
    window; every case timed beside SDPA. fp16 at the two largest buckets,
    GQA and the window, each two runs bitwise equal, then
    :func:`_flash_fp16_cases`. Returns the bf16 and fp16 records at s 768."""
    from apex_tpu_torch.ops.attention import flash_fwd_cuda, flash_fwd_plain
    g = torch.Generator(device="cuda").manual_seed(2)
    records = []
    # (heads, kv_heads, s, window, dtype): the serve buckets at GPT-2
    # widths, a GQA and a sliding-window case, and one f32 check; fp16 at
    # the buckets of 512 and 768, GQA and the window
    cases = [(12, 12, s, None, torch.bfloat16) for s in (64, 128, 256, 512,
                                                         768)]
    cases += [(12, 4, 512, None, torch.bfloat16),
              (12, 12, 768, 256, torch.bfloat16),
              (12, 12, 768, None, torch.float32)]
    cases += [(12, 12, 512, None, torch.float16),
              (12, 12, 768, None, torch.float16),
              (12, 4, 512, None, torch.float16),
              (12, 12, 768, 256, torch.float16)]
    for h, kvh, s, window, dtype in cases:
        d = 64
        q = torch.randn(1, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(1, kvh, s, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(1, kvh, s, d, device="cuda", generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_fwd_cuda(q, k, v, None, scale, True, window)
        ro = flash_fwd_plain(q.float(), k.float(), v.float(), None, scale,
                             True, window)[0].to(dtype)
        torch.cuda.synchronize()
        err = float((o.float() - ro.float()).abs().max())
        ulps, ok, tol = check_close(o, ro)
        same = None
        if dtype == torch.float16:
            again = flash_fwd_cuda(q, k, v, None, scale, True, window)
            same = torch.equal(again[0], o) and torch.equal(again[1], lse)
        if not ok or not torch.isfinite(lse).all() or same is False:
            raise AssertionError(f"flash_fwd h={h} kvh={kvh} s={s} "
                                 f"window={window} {dtype}: max err {err} "
                                 f"({ulps} ulp) — tolerance {tol}; two runs "
                                 f"bitwise equal: {same}")
        esz = q.element_size()
        pairs = _visible_pairs(s, s, True, window, s)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * esz + h * s * 4
        bms, by = bound_ms(n_bytes, 4.0 * d * h * pairs, dtype)
        ms = timer(lambda: flash_fwd_cuda(q, k, v, None, scale, True, window))
        plain = timer(lambda: flash_fwd_plain(q, k, v, None, scale, True,
                                              window),
                      iters=10)
        if window is None:
            gqa = {"enable_gqa": True} if kvh != h else {}
            lib = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, **gqa))
        else:
            idx = torch.arange(s, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & \
                (idx[None, :] > idx[:, None] - window)
            lib = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
        log("kernel_b", shape=f"b1 h{h} kvh{kvh} s{s} d{d}",
            window=window, dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
            ulps=ulps, tol=tol.replace(" ", "_"), ms=f"{ms:.5f}",
            plain_ms=f"{plain:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{bms:.5f}", bound_by=by,
            **({} if same is None else dict(repeat_bitwise=same,
                                            sha256=digest(o))))
        if (h, kvh, s, window) == (12, 12, 768, None) and \
                dtype != torch.float32:
            fp16 = dtype == torch.float16
            records.append(dict(
                name="flash_fwd_fp16" if fp16 else "flash_fwd",
                route="cuda", source="apex_tpu_torch/csrc/flash_fwd.cu",
                replaces="apex_tpu/ops/attention.py:266",
                shape=f"q,k,v[1,12,768,64] {str(dtype)[6:]} causal",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib))
    _flash_fp16_cases(timer, g)
    return records


#: Kernel B's other fp16 cases: (name, b, h, kvh, sq, sk, d, causal,
#: kv_lengths, window) — kv_lengths with a 0 row, head_dim 128, and the
#: T5-base cross-attention of ``[t5_train]`` (phase_flash_bwd's seeded
#: kv_lengths)
FLASH_FP16_CASES = [
    ("kv_lengths_0", 3, 12, 12, 512, 512, 64, False, [512, 200, 0], None),
    ("d128", 1, 12, 12, 512, 512, 128, True, None, None),
    ("t5_cross", T5_BATCH, 12, 12, T5_DEC, T5_ENC, 64, False, "t5", None),
]


def _flash_fp16_cases(timer: Timer, g) -> None:
    """:data:`FLASH_FP16_CASES` in fp16: o within 1 fp16 ulp of the plain
    version run in f32 and rounded once, lse within 1e-4, a row that sees
    no key 0 with lse 1e30, two runs bitwise equal; timed beside SDPA (a
    bool key mask for the lengths)."""
    from apex_tpu_torch.ops.attention import flash_fwd_cuda, flash_fwd_plain
    for name, b, h, kvh, sq, sk, d, causal, kvl, window in FLASH_FP16_CASES:
        if kvl == "t5":
            kvl = _valid_lengths(b, sk, 11).tolist()
        q = torch.randn(b, h, sq, d, device="cuda", generator=g).half()
        k, v = (torch.randn(b, kvh, sk, d, device="cuda", generator=g)
                .half() for _ in range(2))
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        args = (kvl_t, 1.0 / math.sqrt(d), causal, window)
        o, lse = flash_fwd_cuda(q, k, v, *args)
        again = flash_fwd_cuda(q, k, v, *args)
        ro, rlse = flash_fwd_plain(q.float(), k.float(), v.float(), *args)
        ro = ro.half()
        torch.cuda.synchronize()
        err = float((o.float() - ro.float()).abs().max())
        ulps, ok, tol = check_close(o, ro)
        lse_err = float((lse - rlse).abs().max())
        same = torch.equal(again[0], o) and torch.equal(again[1], lse)
        empty_ok = True
        if kvl is not None and 0 in kvl:
            r = kvl.index(0)
            empty_ok = not o[r].any() and bool((lse[r] == 1e30).all())
        if not (ok and lse_err <= 1e-4 and same and empty_ok):
            raise AssertionError(
                f"flash_fwd fp16 {name}: max err {err} ({ulps} ulp; {tol}), "
                f"lse err {lse_err}, bitwise repeat {same}, empty rows "
                f"{empty_ok}")
        mask = (None if kvl_t is None else
                (torch.arange(sk, device="cuda")[None, :]
                 < kvl_t[:, None])[:, None, None, :])
        ms = timer(lambda: flash_fwd_cuda(q, k, v, *args))
        lib = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal))
        log("kernel_b", case=name, shape=f"q[{b},{h},{sq},{d}] "
            f"kv[{b},{kvh},{sk},{d}]".replace(" ", "_"), causal=causal,
            kv_lengths="seeded" if name == "t5_cross" else
            json.dumps(kvl).replace(" ", ""), dtype="float16", max_abs_err=f"{err:.3e}", ulps=ulps,
            tol=tol.replace(" ", "_"), lse_err=f"{lse_err:.2e}",
            repeat_bitwise=same, ms=f"{ms:.5f}", library_ms=f"{lib:.5f}",
            sha256=digest(o))
        del q, k, v, o, lse, again, ro, rlse


def _decode_plan_text(plan) -> str:
    """Kernel C's launch plan as one log field."""
    return (f"{plan.path}:split_pages{plan.split_pages}:splits{plan.splits}"
            f":heads{plan.heads}:grid{'x'.join(map(str, plan.grid))}")


def _decode_inputs(b, hl, group, dh, ps, pps, positions, dtype, g,
                   sentinel=False):
    """Pools whose slots map the pages their rows [0, pos] need, from a
    shuffled pool (the rest of a slot's row is the sentinel n_pages;
    with ``sentinel`` also slot 5's second page), holding the step's
    appended rows."""
    from apex_tpu_torch.ops.decode_attention import append_rows, page_pool
    f = hl // group * dh
    need = [min(pps, p // ps + 1) for p in positions]
    n_pages = max(sum(need), 1)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(3))
    table = torch.full((b, pps), n_pages, dtype=torch.int32)
    used = 0
    for r in range(b):
        table[r, :need[r]] = perm[used:used + need[r]]
        used += need[r]
    if sentinel:
        table[5, 1] = n_pages
    kp = page_pool(n_pages, ps, f, dtype, "cuda")
    vp = page_pool(n_pages, ps, f, dtype, "cuda")
    kp.copy_(torch.randn(kp.shape, device="cuda", generator=g))
    vp.copy_(torch.randn(vp.shape, device="cuda", generator=g))
    q = torch.randn(b, hl, dh, device="cuda", generator=g).to(dtype)
    rows = torch.randn(2, b, f, device="cuda", generator=g).to(dtype)
    pt = table.cuda()
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    append_rows(kp, rows[0], pt, pos, ps)
    append_rows(vp, rows[1], pt, pos, ps)
    return q, kp, vp, pt, pos


def _decode_spans(positions, ps, pps, window, w=1) -> list:
    """Each slot's K/V rows Kernel C must read, ``(first, last)`` or None:
    max(0, pos - window + 1) to min(pos + w - 1, pps * ps - 1) (a
    ``w``-row window reads to its last row's position)."""
    last = pps * ps - 1
    out = []
    for p in positions:
        lo = max(0, p - window + 1) if window else 0
        hi = min(p + w - 1, last)
        out.append((lo, hi) if hi >= lo else None)
    return out


def _decode_rows(positions, ps, pps, window, w=1) -> int:
    """The K/V rows Kernel C must read (see :func:`_decode_spans`)."""
    return sum(hi - lo + 1 for lo, hi in
               filter(None, _decode_spans(positions, ps, pps, window, w)))


def _decode_bytes(q, pt, positions, ps, kvh, window, pool_bytes=None,
                  scales=False) -> int:
    """The bytes Kernel C must move: K and V at the rows of
    :func:`_decode_rows` for every kv head (``pool_bytes`` an element: 1
    for int8 pools; q's size by default), with ``scales`` the fp32 K and
    V scales of every (page, kv head) those rows lie on, q and ctx (``q``
    is ``[b, heads, dh]`` or a window ``[b, w, heads, dh]``), the page
    table and the positions."""
    w = 1 if q.dim() == 3 else q.shape[1]
    b, hl, dh = q.shape[0], q.shape[-2], q.shape[-1]
    spans = list(filter(None, _decode_spans(positions, ps, pt.shape[1],
                                            window, w)))
    rows = sum(hi - lo + 1 for lo, hi in spans)
    pages = sum(hi // ps - lo // ps + 1 for lo, hi in spans)
    item = q.element_size() if pool_bytes is None else pool_bytes
    return 2 * rows * kvh * dh * item + (2 * pages * kvh * 4 if scales
                                         else 0) \
        + 2 * b * w * hl * dh * q.element_size() + pt.numel() * 4 + b * 4


def _decode_window_inputs(b, hl, group, dh, ps, pps, positions, dtype, g,
                          w, int8, sentinel=False):
    """:func:`_decode_inputs` with a ``w``-row query window ``[b, w, heads,
    dh]`` whose rows are appended (rows past a slot's table dropped) and,
    for ``int8``, the pools quantized page by page as a prefill fills them
    (``paged_quant_fill``) before the window's rescale-on-append. Returns
    ``(q, kp, vp, pt, pos, ks, vs)``; the scales are None without
    ``int8``."""
    from apex_tpu_torch.ops.decode_attention import (
        _quant_append, append_rows, page_pool, paged_quant_fill, scale_pool)
    _, kp, vp, pt, pos = _decode_inputs(b, hl, group, dh, ps, pps, positions,
                                        dtype, g, sentinel)
    n_pages, _, f = kp.shape
    q = torch.randn(b, w, hl, dh, device="cuda", generator=g).to(dtype)
    rows = torch.randn(2, b, w, f, device="cuda", generator=g).to(dtype)
    ks = vs = None
    if int8:
        pools = []
        for src in (kp, vp):
            pool = page_pool(n_pages, ps, f, torch.int8, "cuda")
            sc = scale_pool(n_pages, f // dh, "cuda")
            paged_quant_fill(pool, sc, src, torch.arange(n_pages,
                                                         device="cuda"))
            pools.append((pool, sc))
        (kp, ks), (vp, vs) = pools
        _quant_append(kp, ks, rows[0], pt, pos, ps)
        _quant_append(vp, vs, rows[1], pt, pos, ps)
    else:
        append_rows(kp, rows[0], pt, pos, ps)
        append_rows(vp, rows[1], pt, pos, ps)
    return q, kp, vp, pt, pos, ks, vs


def _decode_check(name, q, kp, vp, pt, pos, group, window, ks=None,
                  vs=None) -> tuple:
    """Kernel C against its plain version run in f32 and rounded once
    (1 ulp of the 16-bit type, f32 atol 1e-4; int8 pools dequantized in
    f32 on both sides), two runs bitwise equal; logs the case with its plan and the
    sha256 of its context, and returns (max abs err, plan, ctx)."""
    from apex_tpu_torch.ops.decode_attention import (decode_plain,
                                                     paged_decode_cuda,
                                                     paged_decode_cuda_plan)
    plan = paged_decode_cuda_plan(q, kp, vp, pt, group, window)
    ctx = paged_decode_cuda(q, kp, vp, pt, pos, group, window, ks, vs)
    again = paged_decode_cuda(q, kp, vp, pt, pos, group, window, ks, vs)
    int8 = ks is not None
    ref = decode_plain(q.float(), kp if int8 else kp.float(),
                       vp if int8 else vp.float(), pt, pos, group, window,
                       ks, vs).to(q.dtype)
    torch.cuda.synchronize()
    err = float((ctx.float() - ref.float()).abs().max())
    ulps, ok, tol = check_close(ctx, ref)
    same = torch.equal(ctx, again)
    w = 1 if q.dim() == 3 else q.shape[1]
    log("kernel_c_case", case=name, dtype=str(q.dtype)[6:],
        pool=str(kp.dtype)[6:], w=w,
        shape=f"b{q.shape[0]} heads{q.shape[-2]} group{group} "
        f"dh{q.shape[-1]} page{kp.shape[1]}".replace(" ", "_"),
        window=window, plan=_decode_plan_text(plan),
        max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
        repeat_bitwise=same, sha256=digest(ctx))
    if not ok or not same:
        raise AssertionError(f"paged_decode {name} {q.dtype}: max err {err} "
                             f"({ulps} ulp; {tol}), repeat bitwise {same}")
    return err, plan, ctx


#: Kernel C's cases beside the serve shape: (name, b, heads, group,
#: head_dim, page, pages a slot, positions, window, dtypes, sentinel) —
#: GQA at head_dim 128 over 2048 rows with and without a window, one slot
#: at the serve cell's last row (the old grid's 12 blocks), the card
#: test's corners at pages of 16 (a slot at 0, one at its table's last
#: row, a sentinel inside a slot's range; GQA with a window), and head_dim
#: 60 in bf16 (the element path)
DECODE_CASES = [
    ("gqa", 8, 32, 4, 128, 64, 32, (2047,) * 8, None,
     (torch.bfloat16, torch.float32), False),
    ("gqa_window", 8, 32, 4, 128, 64, 32, (2047,) * 8, 512,
     (torch.bfloat16,), False),
    ("one", 1, 12, 1, 64, 64, 12, (767,), None, (torch.bfloat16,), False),
    ("corners", 6, 12, 3, 64, 16, 8, (0, 15, 16, 77, 127, 40), 20,
     (torch.bfloat16, torch.float32), True),
    ("element_dh60", 8, 12, 1, 60, 64, 12, (63, 64, 200, 700) * 2, None,
     (torch.bfloat16,), False),
    # Gemma-2B's decode: 8 query heads over one K/V head at head_dim 256
    # (bf16 in _decode_hd256, timed)
    ("mqa_dh256", 8, 8, 8, 256, 64, 12, (63, 64, 200, 700) * 2, None,
     (torch.float32,), False),
]


#: Kernel C's int8 pools and w-row windows: (name, b, heads, group,
#: head_dim, page, pages a slot, positions, sliding window, w, int8, path,
#: sentinel) — the serve shape (timed, and the records of the int8 and
#: window variants), GQA 32/8 at w 4 (16 rows a kv head: two chunks), the
#: corners with a sentinel, rows past the table and a sliding window, and
#: head_dim 60 (the element path); bf16 q throughout, f32 q over int8
#: pools on the element path
DECODE_WINDOW_CASES = [
    ("int8", 8, 12, 1, 64, 64, 12, (63, 64, 200, 700) * 2, None, 1, True,
     "vector", False),
    ("w4", 8, 12, 1, 64, 64, 12, (63, 64, 200, 700) * 2, None, 4, False,
     "vector", False),
    ("int8_w4", 8, 12, 1, 64, 64, 12, (63, 64, 200, 700) * 2, None, 4, True,
     "vector", False),
    ("gqa_int8_w4", 8, 32, 4, 128, 64, 32, (2044,) * 8, None, 4, True,
     "vector", False),
    ("corners_w4", 6, 12, 3, 64, 16, 8, (0, 15, 16, 77, 126, 40), 20, 4,
     False, "vector", True),
    ("corners_int8_w2", 6, 12, 3, 64, 16, 8, (0, 15, 16, 77, 127, 40), 20,
     2, True, "vector", True),
    ("element_dh60_int8", 8, 12, 1, 60, 64, 12, (63, 64, 200, 700) * 2, None,
     1, True, "element", False),
    ("element_dh60_w4", 8, 12, 1, 60, 64, 12, (63, 64, 200, 700) * 2, None,
     4, False, "element", False),
    ("element_dh60_int8_w4", 8, 12, 1, 60, 64, 12, (63, 64, 200, 700) * 2,
     None, 4, True, "element", False),
    # Gemma-2B's decode (8 query heads over one K/V head at head_dim 256):
    # int8 pools, a w = 4 window (32 query rows a kv head: four chunks of
    # _MAX_HEADS) and both
    ("mqa_dh256_int8", 8, 8, 8, 256, 64, 12, (63, 64, 200, 700) * 2, None,
     1, True, "vector", False),
    ("mqa_dh256_w4", 8, 8, 8, 256, 64, 12, (63, 64, 200, 700) * 2, None, 4,
     False, "vector", False),
    ("mqa_dh256_int8_w4", 8, 8, 8, 256, 64, 12, (63, 64, 200, 700) * 2,
     None, 4, True, "vector", False),
]
#: the timed window cases that print a kernel record: C's int8 and window
#: variants at the serve shape
DECODE_RECORDS = {"int8": "paged_decode_int8", "w4": "paged_decode_window"}


def _decode_window_phase(timer: Timer, g, half=torch.bfloat16) -> list:
    """Kernel C's int8 and window cases (:data:`DECODE_WINDOW_CASES`) with
    q in ``half`` (and f32 on the element path over int8 pools, with
    bf16): each against its plain version in f32, two runs bitwise equal,
    the int8 append run twice from the same seed bitwise equal (pools and
    scales), the serve-shape ones timed beside their plain version and
    bound. Returns the kernel records (bf16's; fp16's timings are logged
    only: no serve phase runs fp16 with int8 pools or windows)."""
    from apex_tpu_torch.ops.decode_attention import (decode_plain,
                                                     paged_decode_cuda)
    records = []
    for (name, b, hl, group, dh, ps, pps, positions, window, w, int8, path,
         sentinel) in DECODE_WINDOW_CASES:
        for dtype in ((half, torch.float32) if int8 and path == "element"
                      and half == torch.bfloat16 else (half,)):
            args = _decode_window_inputs(b, hl, group, dh, ps, pps,
                                         positions, dtype, g, w, int8,
                                         sentinel)
            q, kp, vp, pt, pos, ks, vs = args
            err, plan, _ = _decode_check(name, q, kp, vp, pt, pos, group,
                                         window, ks, vs)
            if plan.path != path:
                raise AssertionError(f"paged_decode {name} {dtype}: "
                                     f"{plan.path} path")
            if int8:
                seed = 100 + len(records)
                twice = [_decode_window_inputs(
                    b, hl, group, dh, ps, pps, positions, dtype,
                    torch.Generator(device="cuda").manual_seed(seed), w,
                    int8, sentinel) for _ in range(2)]
                for i in (1, 2, 5, 6):
                    if not torch.equal(twice[0][i], twice[1][i]):
                        raise AssertionError(f"int8 append {name}: two runs "
                                             f"differ (output {i})")
                del twice
            if name in DECODE_RECORDS:
                kvh = hl // group
                rows = _decode_rows(positions, ps, pps, window, w)
                bms, by = bound_ms(_decode_bytes(
                    q, pt, positions, ps, kvh, window, 1 if int8 else None,
                    int8), 4.0 * dh * hl * w * rows, dtype)
                run = lambda: paged_decode_cuda(  # noqa: E731
                    q, kp, vp, pt, pos, group, window, ks, vs)
                ms = timer(run, cold=True)
                plain = timer(lambda: decode_plain(
                    q, kp, vp, pt, pos, group, window, ks, vs), cold=True,
                    iters=10)
                log("kernel_c", case=name, shape=f"b{b} heads{hl} dh{dh} "
                    f"page{ps}", w=w, pool=str(kp.dtype)[6:],
                    positions=list(positions[:4]), dtype=str(dtype)[6:],
                    max_abs_err=f"{err:.3e}", ms=f"{ms:.5f}",
                    plain_ms=f"{plain:.5f}", library_ms=None,
                    bound_ms=f"{bms:.5f}", bound_by=by, rows_read=rows,
                    plan=_decode_plan_text(plan))
                if dtype != torch.bfloat16:
                    continue
                records.append(dict(
                    name=DECODE_RECORDS[name], route="cuda",
                    source="apex_tpu_torch/csrc/paged_decode.cu",
                    replaces="apex_tpu/ops/decode_attention.py:272",
                    shape=f"b{b} heads{hl} dh{dh} page{ps} w{w} "
                    f"{str(kp.dtype)[6:]} pools, {str(dtype)[6:]} q, cold L2",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None))
            del args, q, kp, vp, ks, vs
    return records


def phase_decode(timer: Timer) -> list:
    from apex_tpu_torch.ops.decode_attention import (decode_plain,
                                                     paged_decode_cuda)
    g = torch.Generator(device="cuda").manual_seed(3)
    b, hl, dh, ps, max_len = 8, 12, 64, 64, 768
    pps = max_len // ps
    positions = (63, 64, 200, 700) * 2
    records = []
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        q, kp, vp, pt, pos = _decode_inputs(b, hl, 1, dh, ps, pps, positions,
                                            dtype, g)
        err, plan, _ = _decode_check("table", q, kp, vp, pt, pos, 1, None)
        if plan.path != "vector":
            raise AssertionError(f"paged_decode {dtype} at the serve shape "
                                 f"took the {plan.path} path")
        rows = _decode_rows(positions, ps, pps, None)
        bms, by = bound_ms(_decode_bytes(q, pt, positions, ps, hl, None),
                           4.0 * dh * hl * rows, dtype)
        ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, 1, None),
                   cold=True)
        plain = timer(lambda: decode_plain(q, kp, vp, pt, pos, 1, None),
                      cold=True, iters=10)
        log("kernel_c", shape=f"b{b} heads{hl} dh{dh} page{ps}",
            positions=list(positions[:4]), dtype=str(dtype)[6:],
            max_abs_err=f"{err:.3e}", ms=f"{ms:.5f}",
            plain_ms=f"{plain:.5f}", library_ms=None,
            bound_ms=f"{bms:.5f}", bound_by=by, rows_read=rows,
            plan=_decode_plan_text(plan))
        if dtype != torch.float32:
            fp16 = dtype == torch.float16
            records.append(dict(
                name="paged_decode_fp16" if fp16 else "paged_decode",
                route="cuda", source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/decode_attention.py:272",
                shape=f"b{b} heads{hl} dh{dh} page{ps} {str(dtype)[6:]} "
                "cold L2", max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None))
    for (name, b, hl, group, dh, ps, pps, positions, window, dtypes,
         sentinel) in DECODE_CASES:
        for dtype in dtypes + (torch.float16,):
            args = _decode_inputs(b, hl, group, dh, ps, pps, positions,
                                  dtype, g, sentinel)
            _, plan, _ = _decode_check(name, *args, group, window)
            if plan.path != ("element" if name == "element_dh60"
                             else "vector"):
                raise AssertionError(f"paged_decode {name} {dtype}: "
                                     f"{plan.path} path")
            del args
    records.append(_decode_hd256(timer, g))
    records += _decode_window_phase(timer, g)
    _decode_window_phase(timer, g, torch.float16)
    torch.cuda.empty_cache()
    return records


def _decode_hd256(timer: Timer, g) -> dict:
    """Kernel C at ``[gemma2b_serve]``'s decode: b 8, 8 query heads over
    one K/V head at head_dim 256, bf16 pools of 64-row pages, timed cold
    beside its plain version and bound (the record ``paged_decode_hd256``)."""
    from apex_tpu_torch.ops.decode_attention import (decode_plain,
                                                     paged_decode_cuda)
    b, hl, group, dh, ps, pps = 8, 8, 8, 256, 64, 12
    positions = (63, 64, 200, 700) * 2
    dtype = torch.bfloat16
    q, kp, vp, pt, pos = _decode_inputs(b, hl, group, dh, ps, pps, positions,
                                        dtype, g)
    err, plan, _ = _decode_check("mqa_dh256_timed", q, kp, vp, pt, pos,
                                 group, None)
    rows = _decode_rows(positions, ps, pps, None)
    bms, by = bound_ms(_decode_bytes(q, pt, positions, ps, hl // group,
                                     None), 4.0 * dh * hl * rows, dtype)
    ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, group, None),
               cold=True)
    plain = timer(lambda: decode_plain(q, kp, vp, pt, pos, group, None),
                  cold=True, iters=10)
    log("kernel_c", case="mqa_dh256", shape=f"b{b} heads{hl} kvh1 dh{dh} "
        f"page{ps}", positions=list(positions[:4]), dtype="bfloat16",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
        library_ms=None, bound_ms=f"{bms:.5f}", bound_by=by, rows_read=rows,
        plan=_decode_plan_text(plan))
    return dict(name="paged_decode_hd256", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/decode_attention.py:272",
                shape=f"b{b} heads{hl} kvh1 dh{dh} page{ps} bfloat16 cold L2",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


#: (rows, h, dtype, RMSNorm): the training block's LN, bf16 x and dy over
#: fp32 weight and bias (out_dtype=x.dtype), then all-f32, then RMSNorm;
#: the T5 decoder's RMSNorm rows (16 x 114); a bf16 width off the 16-byte
#: path (h % 8 != 0: the element kernel)
LN_BWD_CASES = [(TRAIN_BATCH * TRAIN_SEQ, 768, torch.bfloat16, False),
                (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float32, False),
                (TRAIN_BATCH * TRAIN_SEQ, 768, torch.bfloat16, True),
                (T5_BATCH * T5_DEC, 768, torch.bfloat16, True),
                (2048, 1020, torch.bfloat16, False)]


def phase_layer_norm_bwd(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_cuda_plan,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    record = None
    for rows, h, dtype, is_rms in LN_BWD_CASES:
        w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
        b = 0.1 * torch.randn(h, device="cuda", generator=g)
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        dy = torch.randn(rows, h, device="cuda", generator=g).to(dtype)
        bias = None if is_rms else b
        _, mean, iv = layer_norm_fwd_plain(x, w, bias, 1e-5, is_rms, dtype)
        run = lambda: layer_norm_bwd_cuda(dy, x, mean, iv, w,  # noqa: E731
                                          is_rms, bias is not None)
        dx, dw, db = run()
        again = run()
        rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean,
                                             iv, w, is_rms, bias is not None)
        torch.cuda.synchronize()
        rdx = rdx.to(dtype)
        err = float((dx.float() - rdx.float()).abs().max())
        ulps, ok, tol = check_close(dx, rdx)
        # dw/db: fp32 sums of the rows in another order
        dw_err = max(float(((dw - rdw).abs() / (1.0 + rdw.abs())).max()),
                     0.0 if db is None else
                     float(((db - rdb).abs() / (1.0 + rdb.abs())).max()))
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip((dx, dw, db), again))
        if not ok or dw_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_bwd [{rows},{h}] {dtype} rms={is_rms}: dx err "
                f"{err} ({ulps} ulp, tolerance {tol}), dw/db rel err "
                f"{dw_err} (tolerance 1e-4); two runs bitwise equal: {same}")
        esz = x.element_size()
        n_bytes = 3 * rows * h * esz + 2 * rows * 4 + h * 4 + \
            (1 if is_rms else 2) * h * 4
        bms, by = bound_ms(n_bytes, 12.0 * rows * h, dtype)
        ms = timer(run)
        ms_cold = timer(run, cold=True)
        plain = timer(lambda: layer_norm_bwd_plain(dy, x, mean, iv, w,
                                                   is_rms, bias is not None))
        lib = None
        if not is_rms:
            # the library's own saved statistics (their dtype is its choice)
            wd, bd = w.to(dtype), b.to(dtype)
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wd, bd,
                                                               1e-5)
            lib = timer(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], lmean, lrstd, wd, bd, [True, True, True]))
        log("kernel_d", shape=f"[{rows},{h}]", dtype=str(dtype)[6:],
            rms=is_rms,
            plan=_plan_text(layer_norm_bwd_cuda_plan(dy, x, dx, w,
                                                     bias is not None)),
            max_abs_err=f"{err:.3e}", ulps=ulps,
            tol=tol.replace(" ", "_"), dw_db_rel_err=f"{dw_err:.2e}",
            repeat_bitwise=same, ms=f"{ms:.5f}", ms_cold=f"{ms_cold:.5f}",
            plain_ms=f"{plain:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by, dx_sha256=digest(dx))
        if (rows, h, dtype, is_rms) == LN_BWD_CASES[0]:
            record = dict(name="layer_norm_bwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_bwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:151",
                          shape=f"dy,x[{rows},{h}] bf16, w,b fp32",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


#: fp16 rows of Kernel D (rows, h, w dtype, RMSNorm): amp O2's GPT-2 rows
#: with fp16 w and b (the timed record, beside native_layer_norm_backward
#: in fp16), RMSNorm, O1's fp32 w, a ragged tail and the element path
LN_BWD_FP16_CASES = [
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float16, False),
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float16, True),
    (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float32, False),
    (TRAIN_BATCH * TRAIN_SEQ + 1, 768, torch.float16, False),
    (2048, 1020, torch.float16, False),
]


def phase_layer_norm_bwd_fp16(timer: Timer) -> dict:
    """Kernel D on fp16 dy and x: dx within 1 fp16 ulp of the plain
    version run in fp32 and rounded once, the fp32 dw and db within 1e-4
    of 1 + |value| (sums in another order) and non-finite at the same
    elements once cast to w's dtype, two runs bitwise equal, the plan
    printed; then [64, 768] with dy at 2^12 and w at 32, where dx and the
    fp16 dw and db overflow at the plain version's elements."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_cuda_plan,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(12)
    record = None

    def inputs(rows, h, wdt, is_rms, dy_scale=1.0, w_scale=1.0):
        w = (w_scale * (1.0 + 0.1 * torch.randn(h, device="cuda",
                                                generator=g))).to(wdt)
        bias = None if is_rms else w
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).half()
        dy = (dy_scale * torch.randn(rows, h, device="cuda",
                                     generator=g)).half()
        _, mean, iv = layer_norm_fwd_plain(x, w, None, 1e-5, is_rms,
                                           torch.float16)
        run = lambda: layer_norm_bwd_cuda(dy, x, mean, iv, w,  # noqa: E731
                                          is_rms, bias is not None)
        plain = layer_norm_bwd_plain(dy.float(), x.float(), mean, iv, w,
                                     is_rms, bias is not None)
        return x, dy, w, bias, mean, iv, run, plain

    for rows, h, wdt, is_rms in LN_BWD_FP16_CASES:
        x, dy, w, bias, mean, iv, run, (rdx, rdw, rdb) = inputs(rows, h, wdt,
                                                               is_rms)
        dx, dw, db = run()
        again = run()
        torch.cuda.synchronize()
        rdx = rdx.half()
        err = float((dx.float() - rdx.float()).abs().max())
        ulps, ok, tol = check_close(dx, rdx)
        dw_err = max(float(((dw - rdw).abs() / (1.0 + rdw.abs())).max()),
                     0.0 if db is None else
                     float(((db - rdb).abs() / (1.0 + rdb.abs())).max()))
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip((dx, dw, db), again))
        if not ok or dw_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_bwd fp16 [{rows},{h}] w {wdt} rms={is_rms}: dx "
                f"err {err} ({ulps} ulp, tolerance {tol}), dw/db rel err "
                f"{dw_err} (tolerance 1e-4); two runs bitwise equal: {same}")
        fields = {}
        if record is None:
            n_bytes = 3 * rows * h * 2 + 2 * rows * 4 + h * 2 + 2 * h * 4
            bms, by = bound_ms(n_bytes, 12.0 * rows * h, torch.float16)
            ms = timer(run)
            ms_cold = timer(run, cold=True)
            plain = timer(lambda: layer_norm_bwd_plain(
                dy, x, mean, iv, w, is_rms, bias is not None))
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], w,
                                                               bias, 1e-5)
            lib = timer(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], lmean, lrstd, w, bias, [True, True, True]))
            fields = dict(ms=f"{ms:.5f}", ms_cold=f"{ms_cold:.5f}",
                          plain_ms=f"{plain:.5f}", library_ms=f"{lib:.5f}",
                          bound_ms=f"{bms:.5f}", bound_by=by)
            record = dict(name="layer_norm_bwd_fp16", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_bwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:151",
                          shape=f"dy,x[{rows},{h}] fp16, w,b fp16",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
        log("kernel_d_fp16", shape=f"[{rows},{h}]", w=str(wdt)[6:],
            rms=is_rms,
            plan=_plan_text(layer_norm_bwd_cuda_plan(dy, x, dx, w,
                                                     bias is not None)),
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            dw_db_rel_err=f"{dw_err:.2e}", repeat_bitwise=same,
            dx_sha256=digest(dx), **fields)
    x, dy, w, bias, mean, iv, run, (rdx, rdw, rdb) = inputs(
        64, 768, torch.float16, False, dy_scale=2.0 ** 12, w_scale=32.0)
    dx, dw, db = run()
    _fp16_overflow("kernel_d_fp16_overflow", dx, rdx.half(),
                   shape="[64,768]", dy="2^12", w="32", output="dx")
    for name, got, want in (("dw", dw, rdw), ("db", db, rdb)):
        _fp16_overflow("kernel_d_fp16_overflow", got.half(), want.half(),
                       shape="[64,768]", dy="2^12", w="32",
                       output=f"{name}_cast_to_fp16")
    return record


#: (name, b, s, groups, qpg, d, causal, kv_lengths, window, rot, rate,
#: dtype): the GPT-2 training shape in bf16 (the timed record) and f32,
#: the T5 encoder (its seeded enc_lengths, as ``t5_train`` draws them) and
#: decoder self-attention shapes in bf16 (E timed beside SDPA), then the
#: corner cases at fewer rows
PACKED_CASES = [
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.bfloat16),
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.float32),
    ("t5_encoder", 16, 512, 12, 1, 64, False, "enc_lengths", None, 0, 0.0,
     torch.bfloat16),
    ("t5_decoder", 16, 114, 12, 1, 64, True, None, None, 0, 0.0,
     torch.bfloat16),
    ("gqa_qpg2", 2, 512, 6, 2, 64, True, None, None, 0, 0.0, torch.bfloat16),
    ("rope_half", 2, 512, 12, 1, 64, True, None, None, 32, 0.0,
     torch.bfloat16),
    ("window_256", 2, 1024, 12, 1, 64, True, None, 256, 0, 0.0,
     torch.bfloat16),
    ("kv_lengths_0", 3, 512, 12, 1, 64, False, [512, 200, 0], None, 0, 0.0,
     torch.bfloat16),
    ("dropout_0.1", 2, 512, 12, 1, 64, True, None, None, 0, 0.1,
     torch.bfloat16),
    ("dropout_0.1", 2, 512, 12, 1, 64, True, None, None, 0, 0.1,
     torch.float32),
    # fp16 (amp O2 with half_dtype=float16): the GPT-2 shape (timed), the
    # corners, and a ragged tail of 1000 rows (off the 128-row query and
    # 64-key tiles)
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.float16),
    ("gqa_qpg2", 2, 512, 6, 2, 64, True, None, None, 0, 0.0, torch.float16),
    ("rope_half", 2, 512, 12, 1, 64, True, None, None, 32, 0.0,
     torch.float16),
    ("window_256", 2, 1024, 12, 1, 64, True, None, 256, 0, 0.0,
     torch.float16),
    ("kv_lengths_0", 3, 512, 12, 1, 64, False, [512, 200, 0], None, 0, 0.0,
     torch.float16),
    ("dropout_0.1", 2, 512, 12, 1, 64, True, None, None, 0, 0.1,
     torch.float16),
    ("ragged_s1000", 2, 1000, 12, 1, 64, True, None, None, 0, 0.0,
     torch.float16),
]
#: the 16-bit dtypes whose Kernel F rounds ds and the dropped p
HALF_DTYPES = (torch.bfloat16, torch.float16)
DROPOUT_SEED = -1234567
#: cases whose Kernel E is timed beside SDPA (F at the GPT-2 shape only)
TIMED_E = ("gpt2_train", "t5_encoder", "t5_decoder")


def _packed_unpacked(qkv, b, s, groups, qpg, d):
    """q [b, H, s, d], k/v [b, G, s, d], contiguous, for the library call."""
    t = qkv.reshape(s, b, groups, qpg + 2, d)
    q = t[:, :, :, :qpg].reshape(s, b, groups * qpg, d)
    return (x.permute(1, 2, 0, 3).contiguous()
            for x in (q, t[:, :, :, qpg], t[:, :, :, qpg + 1]))


def _check_dropout_mask(dtype) -> None:
    """With v = I per group (s == d) and a non-causal softmax (every p >
    0), o[i, j] = keep[i, j] * p[i, j] / (1 - rate): Kernel E's keep mask
    is read off and must equal ``hash_keep``'s bit for bit (f32 and the
    16-bit types take different kernels, each hashing on its own)."""
    from apex_tpu_torch.ops.attention import (drop_combo,
                                              flash_packed_fwd_cuda,
                                              hash_keep)
    g = torch.Generator(device="cuda").manual_seed(6)
    b, s, groups, d, rate = 2, 64, 12, 64, 0.1
    q = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    k = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    eye = torch.eye(s, device="cuda")[:, None, None, None, :].expand(
        s, b, groups, 1, d)
    qkv = torch.cat([q, k, eye], dim=3).reshape(s, b, -1).to(
        dtype).contiguous()
    o, _ = flash_packed_fwd_cuda(qkv, None, None, DROPOUT_SEED, rate, 0.125,
                                 False, None, 1, d)
    got = (o.reshape(s, b, groups, d) != 0).permute(1, 2, 0, 3).cpu()
    combo = drop_combo(torch.arange(b)[:, None, None, None],
                       torch.arange(groups)[None, :, None, None])
    want = hash_keep(DROPOUT_SEED, combo, (b, groups, s, s), rate)
    mismatched = int((got != want).sum())
    if mismatched:
        raise AssertionError(f"dropout keep mask differs from hash_keep at "
                             f"{mismatched} of {want.numel()} positions")
    log("kernel_e_dropout_mask", shape=f"b{b} heads{groups} s{s}",
        dtype=str(dtype)[6:], rate=rate, seed=DROPOUT_SEED, kept=int(got.sum()),
        positions=want.numel(), mismatched=0)


def phase_packed(timer: Timer) -> list:
    """Kernels E and F: every case against the plain versions (the
    forward's o and lse, then the backward's dqkv on the plain forward's
    o and lse). E and f32 F within ``check_close``'s tolerance; bf16 and
    fp16 F (which round ds and the dropped p to their type where the JAX
    kernel does, as the plain version does) within 1 ulp plus
    ``flash_packed_bwd_rounding_slack`` with at most 0.1% (bf16) or 0.8%
    (fp16) of the elements past 1 ulp (``check_rounded_factors``). In
    bf16, E's GPT-2 and T5
    cases are timed beside SDPA and must repeat bitwise; F is timed at the
    GPT-2 shape and must repeat bitwise there, and its f32 dqkv digest is
    printed; in fp16 both are timed at the GPT-2 shape beside SDPA in fp16
    and must repeat bitwise. Then the fp16 overflow cases. Returns the
    bf16 and fp16 records of E and F."""
    from apex_tpu_torch.ops.attention import (
        flash_packed_bwd_cuda, flash_packed_bwd_plain,
        flash_packed_bwd_rounding_slack, flash_packed_fwd_cuda,
        flash_packed_fwd_plain)
    from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
    gen = torch.Generator(device="cuda").manual_seed(5)
    recs = []
    for (name, b, s, groups, qpg, d, causal, kvl, window, rot, rate,
         dtype) in PACKED_CASES:
        qkv = torch.randn(s, b, groups * (qpg + 2) * d, device="cuda",
                          generator=gen).to(dtype)
        do = torch.randn(s, b, groups * qpg * d, device="cuda",
                         generator=gen).to(dtype)
        if kvl == "enc_lengths":
            kvl = _valid_lengths(b, s, 14).tolist()   # _t5_batch's seed 13
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        rope = (None if not rot else rope_tables(
            rope_freqs(0, s, rot, 10000.0, device="cuda"), s, d))
        seed = DROPOUT_SEED if rate else None
        args = (kvl_t, rope, seed, rate, 1.0 / math.sqrt(d), causal, window,
                qpg, d)
        # the plain versions compute in fp32 past the RoPE rounding (part
        # of the function), the backward's rounding of ds and the dropped p
        # as well, and round once at the end
        o, lse = flash_packed_fwd_cuda(qkv, *args)
        ro, rlse = flash_packed_fwd_plain(qkv, *args)
        dqkv = flash_packed_bwd_cuda(qkv, do, ro, rlse, *args)
        rdqkv = flash_packed_bwd_plain(qkv, do, ro, rlse, *args)
        torch.cuda.synchronize()
        errs = {}
        for kname, got, want in (("e", o, ro), ("f", dqkv, rdqkv)):
            err = float((got.float() - want.float()).abs().max())
            past = None
            if kname == "f" and dtype in HALF_DTYPES:
                slack = flash_packed_bwd_rounding_slack(qkv, do, ro, rlse,
                                                        *args)
                err, ulps, past, use, ok = check_rounded_factors(
                    got, want, slack)
                tol = f"1 {str(dtype)[6:]} ulp+factor rounding"
                del slack
            else:
                ulps, ok, tol = check_close(got, want)
                use = None
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"kernel {kname} {name} {dtype}: max err {err} "
                    f"({ulps} ulp, share past 1 ulp {past}, bound use "
                    f"{use}) — tolerance {tol}")
            errs[kname] = (err, ulps, tol, past)
        lse_err = float((lse - rlse).abs().max())
        if lse_err > 1e-4:
            raise AssertionError(f"kernel e {name} {dtype}: lse err "
                                 f"{lse_err} — tolerance 1e-4")
        if kvl is not None and 0 in kvl:
            row = kvl.index(0)
            if o[:, row].any() or dqkv[:, row].any() or \
                    not bool((lse[row] == 1e30).all()):
                raise AssertionError(f"kernel e/f {name}: the batch row "
                                     f"with kv_length 0 is not zero")
        timed = (name in TIMED_E and dtype == torch.bfloat16) or \
            (name == "gpt2_train" and dtype == torch.float16)
        fields = {}
        f32_digest = (digest(dqkv) if name == "gpt2_train"
                      and dtype == torch.float32 else None)
        if timed:
            if not torch.equal(o, flash_packed_fwd_cuda(qkv, *args)[0]):
                raise AssertionError(f"kernel e {name}: two runs differ")
            esz = qkv.element_size()
            pairs = sum(_visible_pairs(s, s, causal, window,
                                       s if kvl is None else kvl[r])
                        for r in range(b))
            heads = groups * qpg
            fwd_bytes = (qkv.numel() + o.numel()) * esz + lse.numel() * 4
            bms_e, by_e = bound_ms(fwd_bytes, 4.0 * d * heads * pairs, dtype)
            ms_e = timer(lambda: flash_packed_fwd_cuda(qkv, *args), iters=10)
            plain_e = timer(lambda: flash_packed_fwd_plain(qkv, *args),
                            iters=5, warmup=1)
            q4, k4, v4 = _packed_unpacked(qkv, b, s, groups, qpg, d)
            mask = (None if kvl_t is None else
                    (torch.arange(s, device="cuda")[None, :]
                     < kvl_t[:, None])[:, None, None, :])
            lib_e = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=causal))
            fields = dict(e=(ms_e, plain_e, lib_e, bms_e, by_e))
        if timed and name == "gpt2_train":
            if not torch.equal(dqkv, flash_packed_bwd_cuda(qkv, do, ro, rlse,
                                                           *args)):
                raise AssertionError(f"kernel f {name}: two runs differ")
            bwd_bytes = (2 * qkv.numel() + 2 * o.numel()) * esz \
                + lse.numel() * 4
            bms_f, by_f = bound_ms(bwd_bytes, 10.0 * d * heads * pairs,
                                   dtype)
            ms_f = timer(lambda: flash_packed_bwd_cuda(qkv, do, ro, rlse,
                                                       *args), iters=10)
            plain_f = timer(lambda: flash_packed_bwd_plain(qkv, do, ro, rlse,
                                                           *args),
                            iters=5, warmup=1)
            q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            do4 = do.reshape(s, b, heads, d).permute(1, 2, 0, 3).contiguous()
            lib_f = timer(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
            fields["f"] = (ms_f, plain_f, lib_f, bms_f, by_f)
        for kname in ("e", "f"):
            err, ulps, tol, past = errs[kname]
            t = fields.get(kname)
            extra = {} if past is None else dict(
                share_past_1_ulp=f"{past:.2e}")
            if kname == "f" and f32_digest is not None:
                extra["dqkv_sha256"] = f32_digest
            if kname == "f" and t is not None:
                extra["bitwise_repeat"] = True
            log(f"kernel_{kname}", case=name,
                shape=f"b{b} s{s} groups{groups} qpg{qpg} d{d}",
                causal=causal, window=window, kv_lengths=kvl, rot=rot,
                rate=rate, dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
                ulps=ulps, tol=tol.replace(" ", "_"), **extra,
                **({} if t is None else dict(
                    ms=f"{t[0]:.5f}", plain_ms=f"{t[1]:.5f}",
                    library_ms=f"{t[2]:.5f}", bound_ms=f"{t[3]:.5f}",
                    bound_by=t[4])))
        if timed and name == "gpt2_train":
            tag = str(dtype)[6:].replace("float16", "fp16")
            suffix = "" if dtype == torch.bfloat16 else "_fp16"
            shape = f"qkv[{s},{b},{qkv.shape[-1]}] {tag} causal"
            ms_e, plain_e, lib_e, bms_e, by_e = fields["e"]
            ms_f, plain_f, lib_f, bms_f, by_f = fields["f"]
            recs.append(dict(
                name="flash_packed_fwd" + suffix, route="cuda",
                source="apex_tpu_torch/csrc/flash_packed_fwd.cu",
                replaces="apex_tpu/ops/attention.py:832", shape=shape,
                max_abs_err=errs["e"][0], ms=ms_e, plain_ms=plain_e,
                bound_ms=bms_e, bound_by=by_e, library_ms=lib_e))
            recs.append(dict(
                name="flash_packed_bwd" + suffix, route="cuda",
                source="apex_tpu_torch/csrc/flash_packed_bwd.cu",
                replaces="apex_tpu/ops/attention.py:885", shape=shape,
                max_abs_err=errs["f"][0], ms=ms_f, plain_ms=plain_f,
                bound_ms=bms_f, bound_by=by_f, library_ms=lib_f))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        _check_dropout_mask(dtype)
    _packed_fp16_overflow()
    return recs


def _packed_fp16_overflow() -> None:
    """Kernels E and F in fp16 with inputs scaled past fp16's range, as a
    large loss scale does. E: v at 2^14 (clamped to 65504) under dropout
    0.5, so o = drop(p) v / l passes 65504 wherever a kept v dominates its
    row; F: do at 2^12 and v at 2^6, so ds = p (dp - delta) overflows
    wherever p is not small, and dq and dk take it. Each must give
    non-finite values at the same elements as its plain version (checked
    on a small shape, where no element sits on the overflow boundary by
    chance)."""
    from apex_tpu_torch.ops.attention import (
        flash_packed_bwd_cuda, flash_packed_bwd_plain, flash_packed_fwd_cuda,
        flash_packed_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, groups, d = 2, 128, 4, 64
    qkv = torch.randn(s, b, groups, 3, d, device="cuda", generator=gen)
    e_qkv = qkv.clone()
    e_qkv[:, :, :, 2] = (e_qkv[:, :, :, 2] * 2.0 ** 14).clamp(-65504, 65504)
    args = (None, None, DROPOUT_SEED, 0.5, 0.125, True, None, 1, d)
    e_qkv = e_qkv.reshape(s, b, -1).half()
    o, _ = flash_packed_fwd_cuda(e_qkv, *args)
    ro, _ = flash_packed_fwd_plain(e_qkv, *args)
    _fp16_overflow("kernel_e_fp16_overflow", o, ro,
                   shape=f"b{b} s{s} groups{groups} d{d}", v_scale="2^14",
                   rate=0.5)
    f_qkv = qkv.clone()
    f_qkv[:, :, :, 2] *= 2.0 ** 6
    f_qkv = f_qkv.reshape(s, b, -1).half()
    do = (torch.randn(s, b, groups * d, device="cuda", generator=gen)
          * 2.0 ** 12).half()
    args = (None, None, None, 0.0, 0.125, True, None, 1, d)
    ro, rlse = flash_packed_fwd_plain(f_qkv, *args)
    dqkv = flash_packed_bwd_cuda(f_qkv, do, ro, rlse, *args)
    rdqkv = flash_packed_bwd_plain(f_qkv, do, ro, rlse, *args)
    _fp16_overflow("kernel_f_fp16_overflow", dqkv, rdqkv,
                   shape=f"b{b} s{s} groups{groups} d{d}", do_scale="2^12",
                   v_scale="2^6")


def _valid_lengths(b, s, seed):
    """``[b]`` valid lengths drawn from a seed in [s/2, s], row 0 at s."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g)
    lengths[0] = s
    return lengths


#: (name, x shape, mask, causal sq, scale): BERT's scores with its padding
#: mask, a [b,1,1,s] key mask, causal [96,1024,1024], odd row lengths, the
#: encoder-decoder's key mask at s 114 (Kernel G's element path) and rows
#: of 64 (its 16-byte path, four rows a warp)
SOFTMAX_CASES = [
    ("bert", (16, 12, 512, 512), "padding", 0, 1.0),
    ("key_mask", (4, 12, 512, 512), "key", 0, 1.0),
    ("causal", (1, 96, 1024, 1024), None, 1024, 1.0),
    ("k17", (8, 12, 64, 17), "key", 0, 1.0),
    ("k1000", (2, 12, 100, 1000), "key", 0, 0.125),
    ("k4097", (1, 4, 64, 4097), "key", 0, 2.0),
    ("enc_dec_key", (16, 12, 114, 114), "key", 0, 1.0),
    ("k64", (16, 12, 512, 64), "key", 0, 1.0),
]


def _softmax_mask(kind, shape, seed):
    if kind is None:
        return None
    lengths = _valid_lengths(shape[0], shape[-1], seed).cuda()
    valid = torch.arange(shape[-1], device="cuda")[None, :] < \
        lengths[:, None]
    if kind == "key":
        return ~valid[:, None, None, :]
    # BertModel.build_attention_mask: a padded query row masks every key
    return ~(valid[:, None, None, :] & valid[:, None, :, None])


def phase_softmax(timer: Timer) -> list:
    """Kernels G and H against their plain versions in f32 (atol 1e-5),
    bf16 and fp16 (1 ulp of the plain version run in fp32 and rounded);
    BERT's fully masked rows must be 1/k. The BERT bf16 and fp16 cases are
    timed (their records); then H's fp16 overflow."""
    from apex_tpu_torch.ops.softmax import (softmax_bwd_cuda,
                                            softmax_bwd_plain,
                                            softmax_fwd_cuda,
                                            softmax_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(7)
    records = []
    for name, shape, kind, sq, scale in SOFTMAX_CASES:
        mask = _softmax_mask(kind, shape, 8)
        causal = sq > 0
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = (3 * torch.randn(shape, device="cuda", generator=gen)).to(
                dtype)
            dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            y = softmax_fwd_cuda(x, mask, scale, sq, causal)
            ry = softmax_fwd_plain(x.float(), mask, scale, sq, causal).to(
                dtype)
            dx = softmax_bwd_cuda(dy, y, scale)
            rdx = softmax_bwd_plain(dy.float(), y.float(), scale).to(dtype)
            torch.cuda.synchronize()
            errs = {}
            for kname, got, want in (("g", y, ry), ("h", dx, rdx)):
                err = float((got.float() - want.float()).abs().max())
                if dtype != torch.float32:
                    ulps = ulps16(got, want)
                    ok, tol = ulps <= 1.0, f"1_{str(dtype)[6:]}_ulp"
                else:
                    ulps, ok, tol = 0.0, err <= 1e-5, "atol_1e-5"
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(f"kernel {kname} {name} {dtype}: "
                                         f"max err {err} ({ulps} ulp) — "
                                         f"tolerance {tol}")
                errs[kname] = (err, ulps, tol)
            uniform = None
            if kind == "padding":
                # the query rows whose every key is masked: [n, heads, k]
                rows = y.permute(0, 2, 1, 3)[mask[:, 0].all(dim=-1)]
                k = shape[-1]
                uniform = float((rows.float() * k - 1.0).abs().max())
                if rows.numel() == 0 or uniform > 2.0 ** -8:
                    raise AssertionError(f"kernel g {name} {dtype}: fully "
                                         f"masked rows are not 1/k "
                                         f"({uniform})")
            fields = {}
            if name == "bert" and dtype != torch.float32:
                esz = x.element_size()
                n = x.numel()
                # G reads x only where the mask leaves a key visible (a
                # fully masked row is 1/k whatever x holds), all of the mask,
                # and writes all of y
                seen = int((~mask).expand(shape).sum())
                bms_g, by_g = bound_ms((seen + n) * esz + mask.numel(),
                                       6.0 * seen, torch.float32)
                bms_h, by_h = bound_ms(3 * n * esz, 4.0 * n, torch.float32)
                ms_g = timer(lambda: softmax_fwd_cuda(x, mask, scale, sq,
                                                      causal))
                ms_h = timer(lambda: softmax_bwd_cuda(dy, y, scale))
                plain_g = timer(lambda: softmax_fwd_plain(x, mask, scale, sq,
                                                          causal),
                                iters=5, warmup=1)
                plain_h = timer(lambda: softmax_bwd_plain(dy, y, scale),
                                iters=5, warmup=1)
                lib_g = timer(lambda: torch.softmax(x, -1))
                lib_h = timer(lambda: torch.ops.aten._softmax_backward_data(
                    dy, y, -1, x.dtype))
                fields = dict(g=(ms_g, plain_g, lib_g, bms_g, by_g),
                              h=(ms_h, plain_h, lib_h, bms_h, by_h))
                shape_s = (f"x[{','.join(map(str, shape))}] "
                           f"{str(dtype)[6:]}, mask "
                           f"[{','.join(map(str, mask.shape))}]")
                tag = "_fp16" if dtype == torch.float16 else ""
                records += [
                    dict(name="softmax_fwd" + tag, route="cuda",
                         source="apex_tpu_torch/csrc/softmax_fwd.cu",
                         replaces="apex_tpu/ops/softmax.py:47",
                         shape=shape_s, max_abs_err=errs["g"][0], ms=ms_g,
                         plain_ms=plain_g, bound_ms=bms_g, bound_by=by_g,
                         library_ms=lib_g),
                    dict(name="softmax_bwd" + tag, route="cuda",
                         source="apex_tpu_torch/csrc/softmax_bwd.cu",
                         replaces="apex_tpu/ops/softmax.py:111",
                         shape=shape_s, max_abs_err=errs["h"][0], ms=ms_h,
                         plain_ms=plain_h, bound_ms=bms_h, bound_by=by_h,
                         library_ms=lib_h)]
            for kname in ("g", "h"):
                err, ulps, tol = errs[kname]
                t = fields.get(kname)
                log(f"kernel_{kname}", case=name,
                    shape=f"[{','.join(map(str, shape))}]",
                    mask=None if mask is None
                    else f"[{','.join(map(str, mask.shape))}]",
                    causal=causal, scale=scale, dtype=str(dtype)[6:],
                    max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol,
                    **({"uniform_rows_rel_err": f"{uniform:.2e}"}
                       if kname == "g" and uniform is not None else {}),
                    **({} if t is None else dict(
                        ms=f"{t[0]:.5f}", plain_ms=f"{t[1]:.5f}",
                        library_ms=f"{t[2]:.5f}", bound_ms=f"{t[3]:.5f}",
                        bound_by=t[4])))
            del x, dy, y, ry, dx, rdx
    # H in fp16 under an overflowing loss scale at BERT's shape: dy at 2^14
    # (inf where |dy| passes 65504: a row's s is then inf, and its dx inf,
    # or NaN where dy is inf too) and scale 8, where dx also passes 65504
    # by itself where y is not small. (At 2^12 nothing overflows: y (dy -
    # s) peaks where y is near 1/2, at a quarter of dy's spread.)
    shape = SOFTMAX_CASES[0][1]
    mask = _softmax_mask("padding", shape, 8)
    x = (3 * torch.randn(shape, device="cuda", generator=gen)).half()
    y = softmax_fwd_cuda(x, mask, 1.0, 0, False)
    dy = (torch.randn(shape, device="cuda", generator=gen)
          * 2.0 ** 14).half()
    dx = softmax_bwd_cuda(dy, y, 8.0)
    rdx = softmax_bwd_plain(dy.float(), y.float(), 8.0).half()
    _fp16_overflow("kernel_h_fp16_overflow", dx, rdx,
                   shape=f"[{','.join(map(str, shape))}]", dy="2^14",
                   scale=8.0, dy_nonfinite=int((~torch.isfinite(dy)).sum()))
    return records


#: (name, b, h, kvh, sq, sk, causal, kv_lengths, window): the T5-base
#: cross-attention of the t5_train phase (kv_lengths as it draws them), a
#: multi-block causal GQA case, a window, an empty row, causal sq != sk
FLASH_BWD_CASES = [
    ("t5_cross", T5_BATCH, 12, 12, T5_DEC, T5_ENC, False, "t5", None),
    ("causal_gqa_1024", 2, 12, 6, 1024, 1024, True, None, None),
    ("window_256", 2, 12, 12, 1024, 1024, True, None, 256),
    ("kv_lengths_0", 3, 12, 12, 128, 512, False, [512, 200, 0], None),
    ("causal_sq_ne_sk", 2, 12, 12, 300, 700, True, None, None),
]


def _flash_bwd_timed(timer, q, k, v, do, o, lse, kvl, kvl_t, args, err,
                     name) -> tuple:
    """Kernel I and Kernel B at the T5 cross-attention (kv_lengths
    ``kvl``), each beside its plain version, SDPA (its backward) with a
    bool key mask and its bound: ``(log fields, record)``."""
    from apex_tpu_torch.ops.attention import (backward_floor,
                                              flash_bwd_cuda,
                                              flash_bwd_plain,
                                              flash_fwd_cuda)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    causal, window = args[2], args[3]
    dtype = q.dtype
    esz = q.element_size()
    pairs = sum(_visible_pairs(sq, sk, causal, window, n) for n in kvl)
    rows, keys = (sum(t) for t in zip(*(
        _visible_rows_keys(sq, sk, causal, window, n) for n in kvl)))
    # reads: q, o, do and lse of the query rows that see a key, K and V of
    # the keys that some row sees, kv_lengths; writes: all of dq, dk and dv
    n_bytes = (3 * rows * h * d + 2 * keys * kvh * d + q.numel()
               + 2 * k.numel()) * esz + rows * h * 4 + b * 4
    bms, by = bound_ms(n_bytes, 10.0 * d * h * pairs, dtype)
    # Kernel B: reads q of the rows that see a key, K and V of the keys some
    # row sees, kv_lengths; writes o and lse
    b_bms, b_by = bound_ms(
        (rows * h * d + 2 * keys * kvh * d + o.numel()) * esz
        + lse.numel() * 4 + b * 4, 4.0 * d * h * pairs, dtype)
    b_ms = timer(lambda: flash_fwd_cuda(q, k, v, *args))
    ms = timer(lambda: flash_bwd_cuda(q, k, v, do, o, lse, *args))
    plain = timer(lambda: flash_bwd_plain(q, k, v, do, o, lse, *args),
                  iters=5, warmup=1)
    q4, k4, v4 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    keep = (torch.arange(sk, device="cuda")[None, :]
            < kvl_t[:, None])[:, None, None, :]
    out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep)
    lib = timer(lambda: torch.autograd.grad(out4, (q4, k4, v4), do,
                                            retain_graph=True))
    b_lib = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=keep))
    fields = dict(ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
                  library_ms=f"{lib:.5f}", bound_ms=f"{bms:.5f}",
                  bound_by=by, kernel_b_ms=f"{b_ms:.5f}",
                  kernel_b_library_ms=f"{b_lib:.5f}",
                  kernel_b_bound_ms=f"{b_bms:.5f}", kernel_b_bound_by=b_by)
    record = dict(name=name, route="cuda",
                  source="apex_tpu_torch/csrc/flash_bwd.cu",
                  replaces="apex_tpu/ops/attention.py:669",
                  shape=f"q[{b},{h},{sq},{d}] k,v[{b},{kvh},{sk},{d}] "
                  f"{'fp16' if dtype == torch.float16 else 'bf16'} "
                  "kv_lengths", max_abs_err=err, ms=ms, plain_ms=plain,
                  bound_ms=bms, bound_by=by, library_ms=lib)
    return fields, record


def phase_flash_bwd(timer: Timer) -> list:
    """Kernel I against its plain version on the same inputs (which rounds
    ds and p to the input dtype where the JAX kernels do): f32 atol 1e-4;
    bf16 and fp16 every element within 1 ulp plus the slack of one step of
    each rounded factor (``flash_bwd_rounding_slack``) and at most 0.1%
    (bf16) or 0.8% (fp16) of the elements past 1 ulp; two runs bitwise
    equal; the sha256 of dq, dk and dv printed (equal digests on one seed
    mean bitwise equal outputs). Kernel B is checked at each shape on the
    way (its o within 1 ulp, lse within 1e-4). The T5 cross-attention
    bf16 and fp16 cases are timed, B's forward beside SDPA and I beside
    SDPA's backward, each with its bound (the records ``flash_bwd`` and
    ``flash_bwd_fp16``). Then fp16 with do at 2^12 and v at 2^6, where ds
    overflows: the non-finite elements of dq, dk and dv must be the plain
    version's."""
    from apex_tpu_torch.ops.attention import (flash_bwd_cuda,
                                              flash_bwd_plain,
                                              flash_bwd_rounding_slack,
                                              flash_fwd_cuda,
                                              flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    records = {}
    for name, b, h, kvh, sq, sk, causal, kvl, window in FLASH_BWD_CASES:
        d = 64
        if kvl == "t5":
            kvl = _valid_lengths(b, sk, 11).tolist()
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        scale = 1.0 / math.sqrt(d)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            k = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(
                dtype)
            v = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(
                dtype)
            do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            args = (kvl_t, scale, causal, window)
            o, lse = flash_fwd_cuda(q, k, v, *args)
            ro, rlse = flash_fwd_plain(q.float(), k.float(), v.float(), *args)
            b_ulps, b_ok, b_tol = check_close(o, ro.to(dtype))
            lse_err = float((lse - rlse).abs().max())
            if not b_ok or lse_err > 1e-4:
                raise AssertionError(f"kernel b {name} {dtype}: o {b_ulps} "
                                     f"ulp ({b_tol}), lse err {lse_err}")
            got = flash_bwd_cuda(q, k, v, do, o, lse, *args)
            want = flash_bwd_plain(q, k, v, do, o, lse, *args)
            again = flash_bwd_cuda(q, k, v, do, o, lse, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"kernel i {name} {dtype}: two runs "
                                     f"differ")
            half = dtype != torch.float32
            slack = (flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
                     if half else (None,) * 3)
            err, ulps, past, tol = 0.0, 0.0, 0.0, "atol_1e-4"
            for g_, w_, sl in zip(got, want, slack):
                if half:
                    tol = (f"1_{'fp16' if dtype == torch.float16 else 'bf16'}"
                           "_ulp+factor_rounding")
                    e_, u_, p_, use, ok = check_rounded_factors(g_, w_, sl)
                    err, ulps, past = max(err, e_), max(ulps, u_), \
                        max(past, p_)
                    if not ok:
                        raise AssertionError(
                            f"kernel i {name} {dtype}: {ulps} ulp, "
                            f"{past:.2e} of elements past 1 ulp, bound use "
                            f"{use} — tolerance {tol}")
                    continue
                err = max(err, float((g_.float() - w_.float()).abs().max()))
                if err > 1e-4:
                    raise AssertionError(f"kernel i {name} f32: max err "
                                         f"{err} — tolerance {tol}")
            if kvl is not None and 0 in kvl:
                row = kvl.index(0)
                if any(t[row].any() for t in got):
                    raise AssertionError(f"kernel i {name}: the batch row "
                                         f"with kv_length 0 has gradients")
            fields = {}
            if name == "t5_cross" and half:
                rec = ("flash_bwd" if dtype == torch.bfloat16
                       else "flash_bwd_fp16")
                fields, records[rec] = _flash_bwd_timed(
                    timer, q, k, v, do, o, lse, kvl, kvl_t, args, err, rec)
            log("kernel_i", case=name,
                shape=f"b{b} h{h} kvh{kvh} sq{sq} sk{sk} d{d}",
                causal=causal, window=window,
                kv_lengths=None if kvl is None else len(kvl),
                dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}", ulps=ulps,
                share_past_1_ulp=f"{past:.2e}", tol=tol, bitwise_repeat=True,
                sha256=digest(torch.cat([t.reshape(-1) for t in got])),
                kernel_b_ulps=b_ulps, kernel_b_lse_err=f"{lse_err:.2e}",
                **fields)
    # fp16 overflow: ds = p (dp - delta) past 65504 rounds to inf
    b, h, kvh, sq, sk = 3, 12, 12, 128, 512
    kvl_t = torch.tensor([512, 200, 0], device="cuda")
    q, k = (torch.randn(s_, device="cuda", generator=gen).half()
            for s_ in ((b, h, sq, 64), (b, kvh, sk, 64)))
    v = (64.0 * torch.randn(b, kvh, sk, 64, device="cuda",
                            generator=gen)).half()
    do = (4096.0 * torch.randn(b, h, sq, 64, device="cuda",
                               generator=gen)).half()
    args = (kvl_t, 0.125, False, None)
    o, lse = flash_fwd_cuda(q, k, v, *args)
    got = flash_bwd_cuda(q, k, v, do, o, lse, *args)
    want = flash_bwd_plain(q, k, v, do, o, lse, *args)
    _fp16_overflow("kernel_i_fp16_overflow",
                   torch.cat([t.reshape(-1) for t in got]),
                   torch.cat([t.reshape(-1) for t in want]),
                   case="kv_lengths_0", do_scale="2^12", v_scale="2^6",
                   zero_row_zero=not any(t[2].any() for t in got))
    if any(t[2].any() for t in got):
        raise AssertionError("kernel i fp16 overflow: the row with "
                             "kv_length 0 has gradients")
    return [records["flash_bwd"], records["flash_bwd_fp16"]]


#: Kernels E and F past head_dim 128: (name, b, s, groups, qpg, d, causal,
#: kv_lengths, window, rot, rate) — Gemma-2B's training shape (8 query
#: heads of 256 over one K/V head, RoPE over all 256 columns; timed), a
#: window, kv_lengths with a 0 row, dropout, and head_dim 160 (GQA 2:1)
HD256_PACKED = [
    ("gemma2b_train", GEMMA_BATCH, GEMMA_SEQ, 1, 8, 256, True, None, None,
     256, 0.0),
    ("window_256", 1, 1024, 1, 8, 256, True, None, 256, 256, 0.0),
    ("kv_lengths_0", 3, 512, 1, 8, 256, False, [512, 200, 0], None, 256,
     0.0),
    ("dropout_0.1", 2, 512, 1, 8, 256, True, None, None, 256, 0.1),
    ("d160", 2, 512, 2, 2, 160, True, None, None, 160, 0.0),
]
#: Kernels B and I past head_dim 128: (name, b, h, kvh, sq, sk, d, causal,
#: kv_lengths, window) — JAX's 4D route at Gemma-2B's widths past s 1024
#: (timed), head_dim 160 with GQA and kv_lengths, 200 (a 16-byte row with
#: its last piece past d) and 196 (d % 8 != 0: the element-by-element
#: copies) with a window
HD256_FLASH = [
    ("gemma2b_4d", 2, 8, 1, 2048, 2048, 256, True, None, None),
    ("d160_gqa_kv_lengths", 2, 8, 2, 512, 512, 160, True, [512, 300], None),
    ("d200", 2, 4, 1, 300, 300, 200, True, None, None),
    ("d196_element_window", 1, 4, 2, 260, 260, 196, True, None, 64),
]


def _half_check(kname, case, got, want, slack,
                floor: float = 2.0 ** -8) -> tuple:
    """One output of a 16-bit flash kernel against its plain version:
    ``check_close`` (1 ulp) for a forward (``slack`` None), else
    ``check_rounded_factors`` over the magnitude ``floor``; f32 atol 1e-4.
    Raises on failure; returns (max abs err, ulps, share past 1 ulp, the
    backward's largest share of its bound used at ``floor`` and at 2^-8),
    those shares None for a forward or f32."""
    use = use_2m8 = None
    if got.dtype == torch.float32 or slack is None:
        ulps, ok, tol = check_close(got, want)
        err, past = float((got.float() - want.float()).abs().max()), 0.0
    else:
        err, ulps, past, use, ok = check_rounded_factors(got, want, slack,
                                                         floor)
        use_2m8 = check_rounded_factors(got, want, slack)[3]
        tol = (f"1 ulp + factor rounding (bound use {use:.4f} at floor "
               f"{floor:.3e}, {use_2m8:.4f} at 2^-8)")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"kernel {kname} {case} {got.dtype}: max err "
                             f"{err} ({ulps} ulp, {past:.2e} past 1 ulp) — "
                             f"tolerance {tol}")
    return err, ulps, past, use, use_2m8


def _bound_use_fields(kname: str, use, use_2m8) -> dict:
    """A backward's largest share of its 1-ulp bound used, as log fields:
    at its floor, and at 2^-8 where the floor differs (past head_dim
    256)."""
    if use is None:
        return {}
    fields = {f"{kname}_bound_use": f"{use:.4f}"}
    if use_2m8 != use:
        fields[f"{kname}_bound_use_at_2m8"] = f"{use_2m8:.4f}"
    return fields


def _sdpa_backend(fn) -> str:
    """The backend ``scaled_dot_product_attention`` takes in ``fn``, read
    off the kernels torch.profiler sees: flash, efficient (the CUTLASS
    memory-efficient kernels), cudnn, else math (its GEMMs and softmax),
    with the longest kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0) + \
                e.time_range.elapsed_us()
    if not kernels:
        return "not_measured"
    names = " ".join(kernels).lower()
    kind = ("flash" if "flash" in names else
            "efficient" if "fmha" in names or "efficient" in names else
            "cudnn" if "cudnn" in names else "math")
    top = max(kernels, key=kernels.get)
    return f"{kind}:{top[:60].replace(' ', '_')}"


def _wide_packed(timer: Timer, gen, phase: str, cases, timed: str) -> list:
    """``cases`` (:data:`HD256_PACKED`, :data:`HD512_PACKED`) in f32, bf16
    and fp16: E (o 1 ulp, lse 1e-4) and F (1 ulp plus the rounding slack
    over :func:`backward_floor`, at most 0.1% / 0.8% past 1 ulp) against
    the plain versions, a kv_length-0 row zero, every 16-bit case two runs
    bitwise equal, sha256 of o and dqkv printed as ``[phase]`` lines; the
    case ``timed`` timed in bf16 and fp16 beside SDPA (its backward, and
    forward + backward; its backend named). Returns the bf16 records,
    named ``flash_packed_{fwd,bwd}`` with the phase's ``_hd*`` suffix."""
    from apex_tpu_torch.ops.attention import (
        backward_floor, flash_packed_bwd_cuda, flash_packed_bwd_plain,
        flash_packed_bwd_rounding_slack, flash_packed_fwd_cuda,
        flash_packed_fwd_plain)
    from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
    recs = []
    for (name, b, s, groups, qpg, d, causal, kvl, window, rot,
         rate) in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            qkv = torch.randn(s, b, groups * (qpg + 2) * d, device="cuda",
                              generator=gen).to(dtype)
            do = torch.randn(s, b, groups * qpg * d, device="cuda",
                             generator=gen).to(dtype)
            kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
            rope = None if not rot else rope_tables(rope_freqs(
                0, s, rot, 10000.0, device="cuda"), s, d)
            args = (kvl_t, rope, DROPOUT_SEED if rate else None, rate,
                    1.0 / math.sqrt(d), causal, window, qpg, d)
            o, lse = flash_packed_fwd_cuda(qkv, *args)
            ro, rlse = flash_packed_fwd_plain(qkv, *args)
            dqkv = flash_packed_bwd_cuda(qkv, do, ro, rlse, *args)
            rdqkv = flash_packed_bwd_plain(qkv, do, ro, rlse, *args)
            half = dtype != torch.float32
            slack = (flash_packed_bwd_rounding_slack(qkv, do, ro, rlse, *args)
                     if half else None)
            torch.cuda.synchronize()
            e_err, e_ulps, *_ = _half_check("e", name, o, ro, None)
            f_err, f_ulps, f_past, *f_use = _half_check(
                "f", name, dqkv, rdqkv, slack, backward_floor(d))
            lse_err = float((lse - rlse).abs().max())
            if lse_err > 1e-4:
                raise AssertionError(f"kernel e {name} {dtype}: lse err "
                                     f"{lse_err}")
            if kvl is not None and 0 in kvl:
                row = kvl.index(0)
                if o[:, row].any() or dqkv[:, row].any():
                    raise AssertionError(f"kernel e/f {name}: the batch row "
                                         f"with kv_length 0 is not zero")
            same = None
            if half:
                same = torch.equal(o, flash_packed_fwd_cuda(qkv, *args)[0]) \
                    and torch.equal(dqkv, flash_packed_bwd_cuda(
                        qkv, do, ro, rlse, *args))
                if not same:
                    raise AssertionError(f"kernel e/f {name} {dtype}: two "
                                         f"runs differ")
            fields = {}
            if name == timed and half:
                heads = groups * qpg
                esz = qkv.element_size()
                pairs = b * _visible_pairs(s, s, causal, window, s)
                bms_e, by_e = bound_ms((qkv.numel() + o.numel()) * esz
                                       + lse.numel() * 4,
                                       4.0 * d * heads * pairs, dtype)
                bms_f, by_f = bound_ms((2 * qkv.numel() + 2 * o.numel())
                                       * esz + lse.numel() * 4,
                                       10.0 * d * heads * pairs, dtype)
                ms_e = timer(lambda: flash_packed_fwd_cuda(qkv, *args),
                             iters=10)
                ms_f = timer(lambda: flash_packed_bwd_cuda(
                    qkv, do, ro, rlse, *args), iters=10)
                plain_e = timer(lambda: flash_packed_fwd_plain(qkv, *args),
                                iters=5, warmup=1)
                plain_f = timer(lambda: flash_packed_bwd_plain(
                    qkv, do, ro, rlse, *args), iters=5, warmup=1)
                q4, k4, v4 = _packed_unpacked(qkv, b, s, groups, qpg, d)
                gqa = dict(enable_gqa=True)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, is_causal=True, **gqa)
                lib_e = timer(sdpa)
                backend = _sdpa_backend(sdpa)
                q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
                out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True, **gqa)
                do4 = do.reshape(s, b, heads, d).permute(1, 2, 0, 3) \
                    .contiguous()
                lib_f = timer(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do4, retain_graph=True))
                lib_fb = timer(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True, **gqa),
                    (q4, k4, v4), do4))
                fields = dict(e_ms=f"{ms_e:.5f}", e_plain_ms=f"{plain_e:.5f}",
                              e_library_ms=f"{lib_e:.5f}",
                              e_bound_ms=f"{bms_e:.5f}", e_bound_by=by_e,
                              f_ms=f"{ms_f:.5f}", f_plain_ms=f"{plain_f:.5f}",
                              f_library_ms=f"{lib_f:.5f}",
                              f_library_fwd_bwd_ms=f"{lib_fb:.5f}",
                              f_bound_ms=f"{bms_f:.5f}", f_bound_by=by_f,
                              sdpa_backend=backend)
                if dtype == torch.bfloat16:
                    shape = (f"qkv[{s},{b},{qkv.shape[-1]}] bf16 causal "
                             f"rot{rot}")
                    recs.append(dict(
                        name="flash_packed_fwd" + phase[5:], route="cuda",
                        source="apex_tpu_torch/csrc/flash_packed_fwd.cu",
                        replaces="apex_tpu/ops/attention.py:832",
                        shape=shape, max_abs_err=e_err, ms=ms_e,
                        plain_ms=plain_e, bound_ms=bms_e, bound_by=by_e,
                        library_ms=lib_e))
                    recs.append(dict(
                        name="flash_packed_bwd" + phase[5:], route="cuda",
                        source="apex_tpu_torch/csrc/flash_packed_bwd.cu",
                        replaces="apex_tpu/ops/attention.py:885",
                        shape=shape, max_abs_err=f_err, ms=ms_f,
                        plain_ms=plain_f, bound_ms=bms_f, bound_by=by_f,
                        library_ms=lib_f))
                del q4, k4, v4, out4, do4
            log(phase, kernels="e,f", case=name,
                shape=f"b{b} s{s} groups{groups} qpg{qpg} d{d}",
                causal=causal, window=window,
                kv_lengths=None if kvl is None else
                json.dumps(kvl).replace(" ", ""), rot=rot, rate=rate,
                dtype=str(dtype)[6:], e_max_abs_err=f"{e_err:.3e}",
                e_ulps=e_ulps, lse_err=f"{lse_err:.2e}",
                f_max_abs_err=f"{f_err:.3e}", f_ulps=f_ulps,
                f_share_past_1_ulp=f"{f_past:.2e}",
                **_bound_use_fields("f", *f_use), repeat_bitwise=same,
                o_sha256=digest(o), dqkv_sha256=digest(dqkv), **fields)
            del qkv, do, o, lse, ro, rlse, dqkv, rdqkv, slack
    return recs


def _wide_flash(timer: Timer, gen, phase: str, cases, timed: str) -> tuple:
    """``cases`` (:data:`HD256_FLASH`, :data:`HD512_FLASH`) in f32, bf16
    and fp16 through the wrappers of Kernels B and I, each against its
    plain version (B's o 1 ulp and lse 1e-4, I 1 ulp plus the rounding
    slack over :func:`backward_floor`), a kv_length-0 row zero, every
    16-bit case two runs bitwise equal, sha256 printed as ``[phase]``
    lines; the case ``timed`` timed in bf16 and fp16 beside SDPA (its
    backend named), and driven once through ``flash_attention``'s autograd
    with the launch counts read around it (``[phase_autograd]``: I's main
    path at these widths). Returns (the bf16 records, named ``flash_fwd``
    and ``flash_bwd`` with the phase's ``_hd*`` suffix, those counts)."""
    from apex_tpu_torch.ops import LAUNCHES, flash_attention, reset_launches
    from apex_tpu_torch.ops.attention import (backward_floor,
                                              flash_bwd_cuda,
                                              flash_bwd_plain,
                                              flash_bwd_rounding_slack,
                                              flash_fwd_cuda,
                                              flash_fwd_plain)
    recs, launches = [], None
    for name, b, h, kvh, sq, sk, d, causal, kvl, window in cases:
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        args = (kvl_t, 1.0 / math.sqrt(d), causal, window)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            k, v = (torch.randn(b, kvh, sk, d, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
            do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            o, lse = flash_fwd_cuda(q, k, v, *args)
            ro, rlse = flash_fwd_plain(q.float(), k.float(), v.float(), *args)
            got = flash_bwd_cuda(q, k, v, do, o, lse, *args)
            want = flash_bwd_plain(q, k, v, do, o, lse, *args)
            half = dtype != torch.float32
            slack = (flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
                     if half else (None,) * 3)
            torch.cuda.synchronize()
            b_err, b_ulps, *_ = _half_check("b", name, o, ro.to(dtype),
                                            None)
            lse_err = float((lse - rlse).abs().max())
            if lse_err > 1e-4:
                raise AssertionError(f"kernel b {name} {dtype}: lse err "
                                     f"{lse_err}")
            i_err = i_ulps = i_past = 0.0
            i_use = None
            for g_, w_, sl in zip(got, want, slack):
                e_, u_, p_, *x_ = _half_check("i", name, g_, w_, sl,
                                              backward_floor(d))
                i_err, i_ulps, i_past = (max(i_err, e_), max(i_ulps, u_),
                                         max(i_past, p_))
                if x_[0] is not None:
                    i_use = x_ if i_use is None else [
                        max(a, b_) for a, b_ in zip(i_use, x_)]
            if kvl is not None and 0 in kvl:
                row = kvl.index(0)
                if o[row].any() or any(g_[row].any() for g_ in got):
                    raise AssertionError(f"kernel b/i {name}: the batch row "
                                         f"with kv_length 0 is not zero")
            same = None
            if half:
                same = torch.equal(o, flash_fwd_cuda(q, k, v, *args)[0]) and \
                    all(torch.equal(a, g_) for a, g_ in zip(
                        flash_bwd_cuda(q, k, v, do, o, lse, *args), got))
                if not same:
                    raise AssertionError(f"kernel b/i {name} {dtype}: two "
                                         f"runs differ")
            fields = {}
            if name == timed and half:
                esz = q.element_size()
                pairs = b * _visible_pairs(sq, sk, causal, window, sk)
                bms_b, by_b = bound_ms((2 * q.numel() + 2 * k.numel()) * esz
                                       + lse.numel() * 4,
                                       4.0 * d * h * pairs, dtype)
                bms_i, by_i = bound_ms((4 * q.numel() + 4 * k.numel()) * esz
                                       + lse.numel() * 4,
                                       10.0 * d * h * pairs, dtype)
                ms_b = timer(lambda: flash_fwd_cuda(q, k, v, *args),
                             iters=10)
                ms_i = timer(lambda: flash_bwd_cuda(q, k, v, do, o, lse,
                                                    *args), iters=10)
                plain_b = timer(lambda: flash_fwd_plain(q, k, v, *args),
                                iters=5, warmup=1)
                plain_i = timer(lambda: flash_bwd_plain(q, k, v, do, o, lse,
                                                        *args),
                                iters=5, warmup=1)
                gqa = dict(enable_gqa=True)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=True, **gqa)
                lib_b = timer(sdpa)
                backend = _sdpa_backend(sdpa)
                q4, k4, v4 = (t.detach().clone().requires_grad_()
                              for t in (q, k, v))
                out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True, **gqa)
                lib_i = timer(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do, retain_graph=True))
                fields = dict(b_ms=f"{ms_b:.5f}", b_plain_ms=f"{plain_b:.5f}",
                              b_library_ms=f"{lib_b:.5f}",
                              b_bound_ms=f"{bms_b:.5f}", b_bound_by=by_b,
                              i_ms=f"{ms_i:.5f}", i_plain_ms=f"{plain_i:.5f}",
                              i_library_ms=f"{lib_i:.5f}",
                              i_bound_ms=f"{bms_i:.5f}", i_bound_by=by_i,
                              sdpa_backend=backend)
                del q4, k4, v4, out4
                if dtype == torch.bfloat16:
                    shape = (f"q[{b},{h},{sq},{d}] k,v[{b},{kvh},{sk},{d}] "
                             "bf16 causal")
                    recs.append(dict(
                        name="flash_fwd" + phase[5:], route="cuda",
                        source="apex_tpu_torch/csrc/flash_fwd.cu",
                        replaces="apex_tpu/ops/attention.py:266",
                        shape=shape, max_abs_err=b_err, ms=ms_b,
                        plain_ms=plain_b, bound_ms=bms_b, bound_by=by_b,
                        library_ms=lib_b))
                    recs.append(dict(
                        name="flash_bwd" + phase[5:], route="cuda",
                        source="apex_tpu_torch/csrc/flash_bwd.cu",
                        replaces="apex_tpu/ops/attention.py:438",
                        shape=shape, max_abs_err=i_err, ms=ms_i,
                        plain_ms=plain_i, bound_ms=bms_i, bound_by=by_i,
                        library_ms=lib_i))
                    # the main path: flash_attention's autograd, counted
                    qa, ka, va = (t.detach().clone().requires_grad_()
                                  for t in (q, k, v))
                    torch.cuda.synchronize()
                    reset_launches()
                    flash_attention(qa, ka, va, causal=True).backward(do)
                    torch.cuda.synchronize()
                    launches = dict(LAUNCHES)
                    if launches["flash_fwd"] != 1 or \
                            launches["flash_bwd"] != 1:
                        raise AssertionError(f"{phase} autograd: "
                                             f"launches {launches}")
                    if not (torch.equal(qa.grad, got[0])
                            and torch.equal(ka.grad, got[1])
                            and torch.equal(va.grad, got[2])):
                        raise AssertionError(f"{phase} autograd: grads "
                                             "differ from the wrapper's")
                    log(f"{phase}_autograd", shape=shape.replace(" ", "_"),
                        launches=json.dumps(launches).replace(" ", ""))
                    del qa, ka, va
            log(phase, kernels="b,i", case=name,
                shape=f"b{b} h{h} kvh{kvh} sq{sq} sk{sk} d{d}",
                causal=causal, window=window,
                kv_lengths=None if kvl is None else
                json.dumps(kvl).replace(" ", ""), dtype=str(dtype)[6:],
                b_max_abs_err=f"{b_err:.3e}", b_ulps=b_ulps,
                lse_err=f"{lse_err:.2e}", i_max_abs_err=f"{i_err:.3e}",
                i_ulps=i_ulps, i_share_past_1_ulp=f"{i_past:.2e}",
                **_bound_use_fields("i", *(i_use or (None, None))),
                repeat_bitwise=same, o_sha256=digest(o),
                sha256=digest(torch.cat([t.reshape(-1) for t in got])),
                **fields)
            del q, k, v, do, o, lse, ro, rlse, got, want, slack
    return recs, launches


def phase_flash_hd256(timer: Timer) -> tuple:
    """Kernels E, F, B and I past head_dim 128 (``[flash_hd256]`` lines):
    returns (records, the launches of ``flash_attention``'s autograd at
    Gemma-2B's 4D shape, the main path of ``flash_bwd_hd256``)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    recs = _wide_packed(timer, gen, "flash_hd256", HD256_PACKED,
                        "gemma2b_train")
    flash_recs, launches = _wide_flash(timer, gen, "flash_hd256",
                                       HD256_FLASH, "gemma2b_4d")
    torch.cuda.empty_cache()
    return recs + flash_recs, launches


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in fp32: the norm-wise error of an fp32
    sum taken in another order."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


#: norm-wise tolerance of every fp32 sum of the conv kernels (y and dx in
#: f32; stats, dW, da and db in every dtype): the same fp32 products summed
#: in another order
CONV_SUM_TOL = 1e-5
#: the magnitude floor of the conv kernels' 1-ulp checks of y and dx:
#: 2^-8 in bf16 (ulp 2^-15), 2^-5 in fp16, the same absolute 2^-15. They
#: are fp32 sums over 64 to 4,608 products, and two summation orders of
#: unit-scale products differ by fp32 noise of up to ~2^-16 at the largest
#: of millions of elements, past fp16's ulp at 2^-8 (2^-18)
CONV_FLOOR = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -5}
#: (name, kind, x shape, w shape, (affine, relu) cases, NHW of a 1x1's rows
#: for the library call, timed as the kernel's record). Kernel J's bf16
#: branches: 64 x 128 tiles with the prep pass (layer1_conv3, layer3_conv3
#: at N = 1024) and without (layer4); 128 x 64 tiles without (layer1_conv1,
#: N = 64 over K = 256) and with (tail_200, 200 rows: a ragged last tile);
#: channels off the 16-byte groups (ragged_1x1: fragment stores)
CONV_CASES = [
    ("layer1_conv3", "1x1", (802816, 64), (64, 256), [(True, True)],
     (256, 56, 56), True),
    ("layer1_conv1", "1x1", (802816, 256), (256, 64), [(False, False)],
     (256, 56, 56), False),
    ("layer3_conv3", "1x1", (50176, 256), (256, 1024), [(True, True)],
     (256, 14, 14), False),
    ("layer4_conv1", "1x1", (12544, 2048), (2048, 512), [(False, False)],
     (256, 7, 7), False),
    ("layer4_down", "1x1", (12544, 1024), (1024, 2048), [(False, False)],
     (256, 7, 7), False),
    ("tail_200", "1x1", (200, 64), (64, 96),
     [(False, False), (True, False), (True, True)], None, False),
    ("ragged_1x1", "1x1", (1000, 20), (20, 36),
     [(False, False), (True, False), (True, True)], None, False),
    ("layer1_3x3", "3x3", (256, 56, 56, 64), (3, 3, 64, 64), [(True, True)],
     None, True),
    ("layer2_3x3", "3x3", (256, 28, 28, 128), (3, 3, 128, 128),
     [(True, True)], None, False),
    ("layer3_3x3", "3x3", (256, 14, 14, 256), (3, 3, 256, 256),
     [(True, True)], None, False),
    ("layer4_3x3", "3x3", (256, 7, 7, 512), (3, 3, 512, 512), [(True, True)],
     None, False),
    ("odd", "3x3", (3, 5, 9, 16), (3, 3, 16, 32),
     [(False, False), (True, False), (True, True)], None, False),
    ("ragged", "3x3", (5, 13, 11, 20), (3, 3, 20, 36),
     [(False, False), (True, False), (True, True)], None, False),
]


def _conv_bytes_flops(kind, x_shape, w_shape, affine, esz) -> tuple:
    """``(fwd bytes, fwd FLOPs, bwd bytes, bwd FLOPs)`` a fused conv must
    move and do: each input read once, each output written once; FLOPs of
    the products only (2 a multiply-add; the backward has two)."""
    m = math.prod(x_shape[:-1])
    k, n = w_shape[-2], w_shape[-1]
    taps = 9 if kind == "3x3" else 1
    wn = taps * k * n
    vec = (2 * k if affine else 0) + n             # a, b and the shift
    fwd = (m * k + wn + m * n) * esz + (vec + 2 * n) * 4
    # reads x, w, y, dy, a, b, c, ds; writes dx, dW (fp32), da and db
    bwd = (2 * m * k + wn + 2 * m * n) * esz + (vec + 2 * n + wn
                                                 + (2 * k if affine else 0)) * 4
    flops = 2.0 * m * taps * k * n
    return fwd, flops, bwd, 2 * flops


def _conv_library(kind, x, w, dy, nhw):
    """cuDNN's convolution alone (no affine, no stats) on channels-last
    views of the 16-bit inputs: ``(forward fn, backward fn)``, the backward its
    input and weight gradients."""
    if kind == "1x1":
        b, h, wd = nhw
        x4 = x.reshape(b, h, wd, -1)
        dy4 = dy.reshape(b, h, wd, -1)
        w4 = w.t().reshape(w.shape[1], w.shape[0], 1, 1)
        pad = 0
    else:
        x4, dy4, pad = x, dy, 1
        w4 = w.permute(3, 2, 0, 1)
    xv = x4.permute(0, 3, 1, 2).detach().requires_grad_()
    wv = w4.contiguous(memory_format=torch.channels_last).requires_grad_()
    out = F.conv2d(xv, wv, padding=pad)
    dyv = dy4.permute(0, 3, 1, 2)
    return (lambda: F.conv2d(xv, wv, padding=pad),
            lambda: torch.autograd.grad(out, (xv, wv), dyv,
                                        retain_graph=True))


def phase_conv(timer: Timer) -> tuple:
    """Kernels J-M against their plain versions on the same inputs, with a
    random stats cotangent: bf16 and fp16 y and dx within 1 ulp of the
    plain version run in fp32 and rounded once (magnitudes floored at
    ``CONV_FLOOR``); f32 y and dx, and every fp32 sum (stats, dW, da, db),
    norm-wise within ``CONV_SUM_TOL``; two forward and two backward runs
    bitwise equal; the sha256 of the outputs printed. The layer1 bf16 and
    fp16 cases are the records; every bf16 case at a ResNet-50 shape is
    timed against cuDNN's conv alone, the fp16 records too. Then K and M in
    fp16 with dy at 2^13 and the stats cotangent's ds1 at 2^14, where
    dy_eff overflows: dx, dW, da and db non-finite at the plain version's
    elements."""
    from apex_tpu_torch.ops import conv_fused as cf
    ops = {"1x1": (cf.conv1x1_fwd_cuda, cf.conv1x1_fwd_plain,
                   cf.conv1x1_bwd_cuda, cf.conv1x1_bwd_plain),
           "3x3": (cf.conv3x3_fwd_cuda, cf.conv3x3_fwd_plain,
                   cf.conv3x3_bwd_cuda, cf.conv3x3_bwd_plain)}
    names = {"1x1": ("j", "k", "conv1x1"), "3x3": ("l", "m", "conv3x3")}
    replaces = {"conv1x1_fwd": 63, "conv1x1_bwd": 136, "conv3x3_fwd": 356,
                "conv3x3_bwd": 446}
    gen = torch.Generator(device="cuda").manual_seed(16)
    records = {}
    for name, kind, x_shape, w_shape, acts, nhw, record in CONV_CASES:
        fwd_c, fwd_p, bwd_c, bwd_p = ops[kind]
        fk, bk, stem = names[kind]
        k, n = w_shape[-2], w_shape[-1]
        fan_in = math.prod(w_shape[:-1])
        for affine, relu in acts:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                rnd = lambda *shape: torch.randn(  # noqa: E731
                    shape, device="cuda", generator=gen)
                x = rnd(*x_shape).to(dtype)
                w = (rnd(*w_shape) * fan_in ** -0.5).to(dtype)
                a = (torch.rand(k, device="cuda", generator=gen) + 0.5
                     if affine else None)
                b = rnd(k) if affine else None
                c = 0.1 * rnd(n)
                dy = rnd(*x_shape[:-1], n).to(dtype)
                ds = 0.1 * rnd(2, n)
                args = (a, b, w, c)
                y, st = fwd_c(x, *args, affine, relu)
                y2, st2 = fwd_c(x, *args, affine, relu)
                ry, rst = fwd_p(x, *args, affine, relu)
                got = bwd_c(x, *args, ry, dy, ds, affine, relu)
                again = bwd_c(x, *args, ry, dy, ds, affine, relu)
                want = bwd_p(x, *args, ry, dy, ds, affine, relu)
                torch.cuda.synchronize()
                if not (torch.equal(y, y2) and torch.equal(st, st2)):
                    raise AssertionError(f"kernel {fk} {name} {dtype}: two "
                                         f"runs differ")
                if not all((g is None and h is None) or torch.equal(g, h)
                           for g, h in zip(got, again)):
                    raise AssertionError(f"kernel {bk} {name} {dtype}: two "
                                         f"runs differ")
                errs = {}
                outs = [("y", y, ry), ("dx", got[0], want[0])]
                sums = [("stats", st, rst), ("dw", got[1], want[1])]
                if affine:
                    sums.append(("da_db", got[2], want[2]))
                half = dtype != torch.float32
                for oname, g, h in outs:
                    if half:
                        errs[oname] = ulps16(g, h, CONV_FLOOR[dtype])
                        ok = errs[oname] <= 1.0
                    else:
                        errs[oname] = rel_norm(g, h)
                        ok = errs[oname] <= CONV_SUM_TOL
                    if not ok or not torch.isfinite(g).all():
                        raise AssertionError(
                            f"kernel {fk if oname == 'y' else bk} {name} "
                            f"{dtype} affine={affine} relu={relu}: {oname} "
                            f"err {errs[oname]} (1 ulp / {CONV_SUM_TOL} "
                            f"norm-wise)")
                for sname, g, h in sums:
                    errs[sname] = rel_norm(g, h)
                    if errs[sname] > CONV_SUM_TOL:
                        raise AssertionError(
                            f"kernel {fk if sname == 'stats' else bk} "
                            f"{name} {dtype} affine={affine} relu={relu}: "
                            f"{sname} norm-wise err {errs[sname]} "
                            f"(tolerance {CONV_SUM_TOL})")
                max_err = {"y": float((y.float() - ry.float()).abs().max()),
                           "dx": float((got[0].float()
                                        - want[0].float()).abs().max())}
                timed = {}
                if ((dtype == torch.bfloat16 and (nhw or kind == "3x3")
                     and x.numel() > 10 ** 6)
                        or (dtype == torch.float16 and record)):
                    fb, ff, bb, bf = _conv_bytes_flops(kind, x_shape,
                                                       w_shape, affine, 2)
                    timed["fwd_bound"] = bound_ms(fb, ff, dtype)
                    timed["bwd_bound"] = bound_ms(bb, bf, dtype)
                    timed["fwd"] = timer(lambda: fwd_c(x, *args, affine,
                                                       relu), iters=10)
                    timed["bwd"] = timer(lambda: bwd_c(x, *args, ry, dy, ds,
                                                       affine, relu),
                                         iters=10)
                    lib_f, lib_b = _conv_library(kind, x, w, dy, nhw)
                    timed["fwd_lib"] = timer(lib_f, iters=10)
                    timed["bwd_lib"] = timer(lib_b, iters=10)
                    if record:
                        timed["fwd_plain"] = timer(
                            lambda: fwd_p(x, *args, affine, relu), iters=5,
                            warmup=1)
                        timed["bwd_plain"] = timer(
                            lambda: bwd_p(x, *args, ry, dy, ds, affine,
                                          relu), iters=5, warmup=1)
                digests = {"fwd": digest(torch.cat([
                    y.reshape(-1).float(), st.reshape(-1)])),
                    "bwd": digest(torch.cat([t.reshape(-1).float()
                                             for t in got if t is not None]))}
                for kname, which in ((fk, "fwd"), (bk, "bwd")):
                    fields = {}
                    if timed:
                        bms, by = timed[f"{which}_bound"]
                        fields = dict(ms=f"{timed[which]:.5f}",
                                      library_ms=f"{timed[which + '_lib']:.5f}",
                                      bound_ms=f"{bms:.5f}", bound_by=by)
                        if record:
                            fields["plain_ms"] = \
                                f"{timed[which + '_plain']:.5f}"
                    keys = (("y", "stats") if which == "fwd"
                            else ("dx", "dw", "da_db"))
                    log(f"kernel_{kname}", case=name, kind=kind,
                        x=list(x_shape), w=list(w_shape), affine=affine,
                        relu=relu, dtype=str(dtype)[6:],
                        **{f"{e}_err": f"{errs[e]:.3e}" for e in keys
                           if e in errs},
                        tol="1_ulp/1e-5_normwise", **fields,
                        bitwise_repeat=True, sha256=digests[which])
                if record and half:
                    suffix = "" if dtype == torch.bfloat16 else "_fp16"
                    shape = (f"x[{','.join(map(str, x_shape))}] "
                             f"w[{','.join(map(str, w_shape))}] "
                             f"{'bf16' if not suffix else 'fp16'}"
                             f"{' affine+relu' if affine and relu else ''}")
                    for which, oname in (("fwd", "y"), ("bwd", "dx")):
                        kname = f"{stem}_{which}"
                        bms, by = timed[f"{which}_bound"]
                        records[kname + suffix] = dict(
                            name=kname + suffix, route="cuda",
                            source=f"apex_tpu_torch/csrc/{kname}.cu",
                            replaces="apex_tpu/ops/conv_fused.py:"
                                     f"{replaces[kname]}",
                            shape=shape, max_abs_err=max_err[oname],
                            ms=timed[which], plain_ms=timed[which + "_plain"],
                            bound_ms=bms, bound_by=by,
                            library_ms=timed[which + "_lib"])
                del x, w, dy, y, y2, ry, got, again, want
    torch.cuda.empty_cache()
    # fp16 overflow: dy_eff = dy + ds0 + 2 (y - c) ds1 past 65504
    for kind, x_shape, w_shape in (("1x1", (200, 64), (64, 96)),
                                   ("3x3", (3, 5, 9, 16), (3, 3, 16, 32))):
        fwd_c, fwd_p, bwd_c, bwd_p = ops[kind]
        k, n = w_shape[-2], w_shape[-1]
        rnd = lambda *shape: torch.randn(shape, device="cuda",  # noqa
                                         generator=gen)
        x = rnd(*x_shape).half()
        w = (rnd(*w_shape) * math.prod(w_shape[:-1]) ** -0.5).half()
        a = torch.rand(k, device="cuda", generator=gen) + 0.5
        b = rnd(k)
        c = 0.1 * rnd(n)
        dy = (8192.0 * rnd(*x_shape[:-1], n)).half()
        ds = torch.stack([0.1 * rnd(n), 16384.0 * rnd(n)])
        y, _ = fwd_p(x, a, b, w, c, True, True)
        got = bwd_c(x, a, b, w, c, y, dy, ds, True, True)
        want = bwd_p(x, a, b, w, c, y, dy, ds, True, True)
        _fp16_overflow(f"kernel_{names[kind][1]}_fp16_overflow",
                       torch.cat([t.reshape(-1).float() for t in got]),
                       torch.cat([t.reshape(-1).float() for t in want]),
                       case=kind, x=list(x_shape), w=list(w_shape),
                       dy_scale="2^13", ds1_scale="2^14",
                       dy_finite=bool(torch.isfinite(dy).all()))
    return tuple(records[k + sfx] for sfx in ("", "_fp16")
                 for k in ("conv1x1_fwd", "conv1x1_bwd", "conv3x3_fwd",
                           "conv3x3_bwd"))


def _requests(n, vocab, max_new, seed):
    from apex_tpu_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(
        0, vocab, (PROMPT_LENS[i % len(PROMPT_LENS)],), generator=g).tolist(),
        max_new_tokens=max_new) for i in range(n)]


def profile_device(path: str, fn, describe=dict) -> None:
    """Where ``fn``'s time goes: torch.profiler around it — device-busy
    share of the wall time and the kernels by device time, printed as
    ``[profile]`` (with the fields ``describe()`` gives after the run) and
    ``[profile_kernel]`` lines tagged with ``path``. Costs host time while
    on, so its wall is not the phase's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels only (operator rows would count their kernels twice, and a
    # user annotation such as ``Optimizer.step`` spans its kernels)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per_kernel.values()) / 1e6
    log("profile", path=path, **describe(), wall_s=f"{wall:.3f}",
        device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.3f}",
        device_launches=sum(c for c, _ in per_kernel.values()))
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    for name, (calls, us) in ranked[:PROFILE_TOP]:
        log("profile_kernel", path=path, device_ms=f"{us / 1e3:.3f}",
            calls=calls, name=name[:90].replace(" ", "_"))
    rest = ranked[PROFILE_TOP:]
    log("profile_kernel", path=path,
        device_ms=f"{sum(us for _, (_, us) in rest) / 1e3:.3f}",
        calls=sum(c for _, (c, _) in rest), name=f"{len(rest)}_other_kernels")


def profile_serve(model, ecfg) -> None:
    """8 requests on a fresh engine under the profiler."""
    from apex_tpu_torch.serving import InferenceEngine
    engine = InferenceEngine(model, ecfg)
    requests = _requests(8, model.config.vocab_size, 16, 7)
    profile_device("serve", lambda: engine.serve(requests), lambda: dict(
        requests=8, decode_steps=engine.metrics.counters()["decode_steps"]))


def phase_serve(profile: bool = False) -> dict:
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**GPT2, params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64,
                        prefix_cache=False)
    # warm-up on its own engine: cuBLAS handles and first-call costs
    InferenceEngine(model, ecfg).serve(_requests(2, cfg.vocab_size, 4, 9))
    engine = InferenceEngine(model, ecfg)
    requests = _requests(16, cfg.vocab_size, 32, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != 16 or bad:
        raise AssertionError(f"serve: {len(results)} results, bad finish "
                             f"reasons {bad}")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")
    tokens = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results)
    step = engine.metrics.histogram("decode_step_s")
    steps = engine.metrics.counters()["decode_steps"]
    log("serve", model="gpt2-124m bf16 random-init", requests=16,
        tokens=tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{tokens / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}",
        decode_ms_per_step=f"{1e3 * step.sum / step.count:.3f}",
        decode_steps=steps, prefills=engine.metrics.counters()["prefills"],
        launches=json.dumps(launches).replace(" ", ""))
    if profile:
        profile_serve(model, ecfg)
    return launches


def _prefix_requests(n, vocab, max_new, seed, prefix_len=512,
                     suffix=(16, 200)):
    """``n`` greedy requests sharing one ``prefix_len``-token prompt prefix
    (8 pages of 64), each with its own suffix of 16-200 tokens (or the
    ``suffix`` range)."""
    from apex_tpu_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    prefix = torch.randint(0, vocab, (prefix_len,), generator=g).tolist()
    lens = torch.randint(suffix[0], suffix[1] + 1, (n,), generator=g).tolist()
    return [Request(prompt=prefix + torch.randint(
        0, vocab, (k,), generator=g).tolist(), max_new_tokens=max_new)
        for k in lens]


#: the serve phases of the prefix cache, int8 pools and speculation: (name,
#: engine knobs beside 8 slots of 768 and pages of 64, requests)
SERVE_FEATURES = [
    ("serve_prefix", dict(prefix_cache=True), "prefix"),
    ("serve_int8", dict(prefix_cache=False, kv_dtype="int8"), "serve"),
    ("serve_spec", dict(prefix_cache=False, speculation=4), "serve"),
]


def phase_serve_feature(name, knobs, kind, profile: bool = False) -> dict:
    """GPT-2 124M in bf16 at full width serves 16 greedy requests with one
    feature on (see :data:`SERVE_FEATURES`): every request ends
    ``length``/``eos``, Kernel C launched exactly decode steps x 12
    layers; the prefix phase needs >= 15 hits of 16 and Kernel B launched
    only for the misses' full prefills (12 a miss: the suffix prefills run
    the unfused softmax, no kernel). Logs tokens/s, TTFT p50, decode
    ms/step, and the acceptance rate or the pages shared; with
    ``profile``, a profiler breakdown of 8 more requests on a fresh
    engine."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**GPT2, params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64, **knobs)
    make = _prefix_requests if kind == "prefix" else _requests
    # warm-up on its own engine: cuBLAS handles and first-call costs
    InferenceEngine(model, ecfg).serve(make(2, cfg.vocab_size, 4, 9))
    engine = InferenceEngine(model, ecfg)
    requests = make(16, cfg.vocab_size, 32, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    counters = engine.metrics.counters()
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != 16 or bad:
        raise AssertionError(f"{name}: {len(results)} results, bad finish "
                             f"reasons {bad}")
    steps = counters["decode_steps"]
    if launches["paged_decode"] != steps * GPT2["num_layers"]:
        raise AssertionError(f"{name}: Kernel C launched "
                             f"{launches['paged_decode']} times for {steps} "
                             f"decode steps of {GPT2['num_layers']} layers")
    extra = {}
    if kind == "prefix":
        hits, misses = counters["prefix_hits"], counters["prefix_misses"]
        if hits < 15 or launches["flash_fwd"] != misses * GPT2["num_layers"] \
                or launches["softmax_fwd"]:
            raise AssertionError(
                f"{name}: {hits} hits, {misses} misses, Kernel B launched "
                f"{launches['flash_fwd']} times, G {launches['softmax_fwd']}")
        extra = dict(prefix_hits=hits, prefix_misses=misses,
                     pages_shared=counters["prefix_pages_shared"])
    if knobs.get("speculation"):
        prop = counters["draft_tokens_proposed"]
        acc = counters["draft_tokens_accepted"]
        extra = dict(draft_proposed=prop, draft_accepted=acc,
                     accept_rate=f"{acc / prop:.4f}" if prop else None)
    tokens = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results)
    step = engine.metrics.histogram("decode_step_s")
    log(name, model="gpt2-124m bf16 random-init", requests=16,
        knobs=json.dumps(knobs).replace(" ", ""), tokens=tokens,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{tokens / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}",
        decode_ms_per_step=f"{1e3 * step.sum / step.count:.3f}",
        decode_steps=steps, prefills=counters["prefills"], **extra,
        launches=json.dumps(launches).replace(" ", ""))
    if profile:
        fresh = InferenceEngine(model, ecfg)
        profile_device(name, lambda: fresh.serve(
            make(8, cfg.vocab_size, 16, 7)), lambda: dict(
                requests=8,
                decode_steps=fresh.metrics.counters()["decode_steps"]))
    del engine, model
    torch.cuda.empty_cache()
    return launches


def phase_features_card_vs_cpu() -> None:
    """A small f32 GPT (TF32 off, set in ``main``) serves requests sharing
    a prefix through the prefix cache, int8 pools and speculation (3) on
    the card and on the CPU: the greedy tokens are equal."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**SMALL)
    out = {}
    for knobs in (dict(prefix_cache=True), dict(kv_dtype="int8"),
                  dict(speculation=3)):
        for device in ("cuda", "cpu"):
            model = GPTModel(cfg, device=device,
                             generator=torch.Generator().manual_seed(0))
            reqs = _prefix_requests(6, cfg.vocab_size, 8, 4, prefix_len=48,
                                    suffix=(4, 40))
            eng = InferenceEngine(model, EngineConfig(
                max_slots=4, max_len=128, page_size=16, **knobs),
                device=device)
            out[device] = [r.tokens for r in eng.serve(reqs)]
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"card vs CPU greedy tokens differ with "
                                 f"{knobs}: {out}")
        log("features_card_vs_cpu", knobs=json.dumps(knobs).replace(" ", ""),
            requests=6, tokens=sum(map(len, out["cuda"])), equal=True)


def _with_sampling(requests, seed):
    """The requests again, every odd one sampled: temperatures 0.7 and 1.0
    and top_k None and 8 in all four pairs, seeds drawn from ``seed``."""
    from apex_tpu_torch.serving import Request, SamplingParams
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, r in enumerate(requests):
        sp = SamplingParams()
        if i % 2:
            sp = SamplingParams(temperature=(0.7, 1.0)[(i // 2) % 2],
                                top_k=(None, 8)[(i // 4) % 2],
                                seed=int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                       generator=g)))
        out.append(Request(prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens, sampling=sp))
    return out


def device_work(fn) -> tuple:
    """``(device operations, their device ms, {name: (count, ms)})`` of
    what ``fn`` enqueues (kernels and copies), read by torch.profiler;
    "not_measured" for the first two when the profiler sees no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            c, ms = by.get(e.name, (0, 0.0))
            by[e.name] = (c + 1, ms + e.time_range.elapsed_us() / 1e3)
    if not by:
        return "not_measured", "not_measured", by
    return (sum(c for c, _ in by.values()),
            sum(ms for _, ms in by.values()), by)


def count_device_launches(fn):
    """Device operations (kernels and copies) ``fn`` enqueues."""
    return device_work(fn)[0]


def _decode_step_launches(model, ecfg, requests) -> dict:
    """Device operations of one decode tick with 8 slots decoding (no
    admission in the tick): with the requests as given, and with every
    request greedy; and of the sampling alone over the sampled rows."""
    from apex_tpu_torch.serving import InferenceEngine, Request
    from apex_tpu_torch.serving.engine import _sample_tokens
    out = {}
    for name, reqs in (("greedy", [
            Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in requests]), ("sampled", requests)):
        engine = InferenceEngine(model, ecfg)
        for r in reqs[:8]:
            engine.submit(r)
        while engine.queued_count:
            engine.tick()
        engine.tick()                       # a warm decode-only tick
        out[f"{name}_decode_step_launches"] = count_device_launches(
            engine.tick)
    # the sampling alone, over the last engine's sampled rows
    rows = [s for s in sorted(engine._active) if engine._temps_h[s] > 0]

    def up(a, dtype):
        return torch.as_tensor(a[rows], dtype=dtype, device="cuda")

    args = (torch.randn(len(rows), model.config.vocab_size, device="cuda"),
            up(engine._temps_h, torch.float32),
            up(engine._topks_h, torch.int32),
            up(engine._seeds_h, torch.int32),
            up(engine._positions_h, torch.int64) + 1)
    _sample_tokens(*args)
    out["sampling_launches"] = count_device_launches(
        lambda: _sample_tokens(*args))
    out["sampled_rows"] = len(rows)
    return out


def _serve_timed(name, make_engine, requests):
    """Serve ``requests`` on a fresh engine (or supervisor) after a
    warm-up on its own; returns (results, wall seconds, launches, the
    engine)."""
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    make_engine().serve(requests[:2])
    engine = make_engine()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != len(requests) or bad:
        raise AssertionError(f"{name}: {len(results)} results, bad finish "
                             f"reasons {bad}")
    return results, wall, launches, engine


def _serve_line(name, results, wall, metrics, launches,
                model="gpt2-124m bf16 random-init", **extra) -> None:
    tokens = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results if r.ttft_s is not None)
    step = metrics.histogram("decode_step_s")
    counters = metrics.counters()
    log(name, model=model, requests=len(results),
        tokens=tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{tokens / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}" if ttft else None,
        decode_ms_per_step=f"{1e3 * step.sum / step.count:.3f}",
        decode_steps=counters["decode_steps"],
        prefills=counters["prefills"], **extra,
        launches=json.dumps(launches).replace(" ", ""))


def phase_serve_paths(seed: int, profile: bool = False) -> dict:
    """GPT-2 124M in bf16 at full width, 8 slots of 768 and pages of 64,
    serves the ``[serve]`` request set through the engine's other paths:
    sampled (half the requests), chunked prefill (budget 256), the flat
    layout, and a supervisor that restarts the engine after an injected
    decode and an injected prefill failure. Every request must end
    ``length``/``eos``; the launch counts must be as each path implies.
    With ``profile``, a profiler breakdown of 8 more requests on a fresh
    engine (or supervisor) of each path. Returns each path's launch
    counters."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                        InferenceEngine)
    from apex_tpu_torch.testing_faults import ServingFaultInjector
    cfg = TransformerConfig(**GPT2, params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    layers = GPT2["num_layers"]
    base = dict(max_slots=8, max_len=768, page_size=64, prefix_cache=False)
    greedy = _requests(16, cfg.vocab_size, 32, 1)
    paths = {}

    def profiled(name, make_engine, reqs):
        if not profile:
            return
        fresh = make_engine()
        metrics = fresh.metrics
        profile_device(name, lambda: fresh.serve(reqs[:8]), lambda: dict(
            requests=8, decode_steps=metrics.counters()["decode_steps"]))

    # sampled
    ecfg = EngineConfig(**base)
    reqs = _with_sampling(greedy, seed)
    results, wall, launches, engine = _serve_timed(
        "serve_sampled", lambda: InferenceEngine(model, ecfg), reqs)
    steps = engine.metrics.counters()["decode_steps"]
    if launches["paged_decode"] != steps * layers or \
            launches["flash_fwd"] != 16 * layers:
        raise AssertionError(f"serve_sampled: launches {launches} for "
                             f"{steps} decode steps")
    _serve_line("serve_sampled", results, wall, engine.metrics, launches,
                sampled=sum(r.sampling.temperature > 0 for r in reqs),
                **_decode_step_launches(model, ecfg, reqs))
    profiled("serve_sampled", lambda: InferenceEngine(model, ecfg), reqs)
    paths["serve_sampled"] = launches

    # chunked prefill
    ecfg = EngineConfig(**base, prefill_token_budget=256)
    results, wall, launches, engine = _serve_timed(
        "serve_chunked", lambda: InferenceEngine(model, ecfg), greedy)
    counters = engine.metrics.counters()
    chunks = counters["prefill_chunks"]
    steps = counters["decode_steps"]
    # every chunk runs the suffix program (the unfused masked softmax, no
    # kernel B), as the JAX engine's chunks do
    long_prompts = sum(len(r.prompt) > 256 for r in greedy)
    if chunks < 16 + long_prompts or launches["flash_fwd"] or \
            launches["paged_decode"] != steps * layers or \
            engine.metrics.histogram("prefill_tokens_per_tick").max > 256:
        raise AssertionError(f"serve_chunked: {chunks} chunks, launches "
                             f"{launches} for {steps} decode steps")
    _serve_line("serve_chunked", results, wall, engine.metrics, launches,
                prefill_chunks=chunks,
                chunks_per_request=json.dumps(
                    [r.prefill_chunks for r in results]).replace(" ", ""))
    profiled("serve_chunked", lambda: InferenceEngine(model, ecfg), greedy)
    paths["serve_chunked"] = launches

    # the flat layout
    ecfg = EngineConfig(max_slots=8, max_len=768, kv_layout="flat")
    results, wall, launches, engine = _serve_timed(
        "serve_flat", lambda: InferenceEngine(model, ecfg), greedy)
    prefills = engine.metrics.counters()["prefills"]
    if launches["paged_decode"] or launches["flash_fwd"] != \
            prefills * layers or launches["layer_norm_fwd"] <= 0:
        raise AssertionError(f"serve_flat: launches {launches} for "
                             f"{prefills} prefills")
    _serve_line("serve_flat", results, wall, engine.metrics, launches)
    profiled("serve_flat", lambda: InferenceEngine(model, ecfg), greedy)
    paths["serve_flat"] = launches

    # supervised, one decode and one prefill failure injected
    ecfg = EngineConfig(**base)
    injectors = []

    def supervised():
        injectors.append(ServingFaultInjector(decode_raise_calls={5},
                                              prefill_raise_calls={11}))
        return EngineSupervisor(model, ecfg, faults=injectors[-1])

    results, wall, launches, sup = _serve_timed(
        "serve_supervised", supervised, greedy)
    counters = sup.metrics.counters()
    if counters["engine_restarts"] != 2 or len(injectors[-1].log) != 2 or \
            not launches["paged_decode"] or not launches["flash_fwd"]:
        raise AssertionError(f"serve_supervised: counters {counters}, "
                             f"faults {injectors[-1].log}, launches "
                             f"{launches}")
    _serve_line("serve_supervised", results, wall, sup.metrics, launches,
                engine_restarts=counters["engine_restarts"],
                requests_recovered=counters["requests_recovered"],
                faults=json.dumps(injectors[-1].log).replace(" ", ""))
    profiled("serve_supervised", supervised, greedy)
    paths["serve_supervised"] = launches
    del sup, engine, model
    torch.cuda.empty_cache()
    return paths


def _serve_metrics(results, wall, metrics) -> tuple:
    """(tokens/s, TTFT p50 ms, decode ms a step) of one serve."""
    ttft = sorted(r.ttft_s for r in results)
    step = metrics.histogram("decode_step_s")
    return (sum(len(r.tokens) for r in results) / wall,
            1e3 * ttft[len(ttft) // 2], 1e3 * step.sum / step.count)


def phase_serve_fp16(profile: bool = False) -> dict:
    """``[serve_fp16]``: GPT-2 124M with fp16 weights (``compute_dtype``
    fp16: the engine casts the seeded fp32 weights once, and its pools are
    fp16) serves ``[serve]``'s 16 greedy requests at its engine size
    (prompts 64-700, 32 new tokens, 8 slots of 768, pages of 64, no prefix
    cache): every request ends ``length``/``eos``, Kernel C launched
    exactly decode steps x 12 and B 12 a prefill, A at least once, every
    other kernel 0. Then ``[serve_fp16_pairs]``: the bf16 model of
    ``[serve]`` and the fp16 one serve the same requests on fresh engines
    in turns (bf16, fp16, fp16, bf16), each after its own warm-up: tokens/s,
    TTFT p50 and decode ms a step of each (host clocks: compare within the
    pairs). Returns the launches of ``[serve_fp16]``."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64,
                        prefix_cache=False)
    models = {dt: GPTModel(TransformerConfig(
        **GPT2, params_dtype=torch.float32, compute_dtype=dt), device="cuda",
        generator=torch.Generator().manual_seed(0))
        for dt in (torch.float16, torch.bfloat16)}
    requests = _requests(16, GPT2["vocab_size"], 32, 1)
    results, wall, launches, engine = _serve_timed(
        "serve_fp16", lambda: InferenceEngine(models[torch.float16], ecfg),
        requests)
    pools = engine._caches[0][0]
    counters = engine.metrics.counters()
    layers = GPT2["num_layers"]
    want = {k: 0 for k in ALL_KERNELS if k != "layer_norm_fwd"}
    want.update(paged_decode=counters["decode_steps"] * layers,
                flash_fwd=counters["prefills"] * layers)
    got = {k: v for k, v in launches.items() if k != "layer_norm_fwd"}
    if got != want or launches["layer_norm_fwd"] <= 0 or \
            pools.dtype != torch.float16 or \
            engine.model.embedding.word_embeddings.weight.dtype != \
            torch.float16:
        raise AssertionError(
            f"serve_fp16: launches {launches}, expected {want} and "
            f"layer_norm_fwd > 0; pools {pools.dtype}")
    _serve_line("serve_fp16", results, wall, engine.metrics, launches,
                model="gpt2-124m fp16 random-init", pool=str(pools.dtype)[6:])
    del engine
    runs = {torch.bfloat16: [], torch.float16: []}
    for dt in (torch.bfloat16, torch.float16, torch.float16, torch.bfloat16):
        res, w, _, eng = _serve_timed(
            f"serve_pair_{str(dt)[6:]}",
            lambda: InferenceEngine(models[dt], ecfg), requests)
        runs[dt].append(_serve_metrics(res, w, eng.metrics))
        del eng
    fields = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        for i, key in enumerate(("tokens_per_s", "ttft_p50_ms",
                                 "decode_ms_per_step")):
            fields[f"{key}_{name}"] = json.dumps(
                [round(r[i], 3) for r in runs[dt]]).replace(" ", "")
    log("serve_fp16_pairs", order="bf16,fp16,fp16,bf16", **fields)
    if profile:
        fresh = InferenceEngine(models[torch.float16], ecfg)
        profile_device("serve_fp16", lambda: fresh.serve(
            _requests(8, GPT2["vocab_size"], 16, 7)), lambda: dict(
                requests=8,
                decode_steps=fresh.metrics.counters()["decode_steps"]))
    del models
    torch.cuda.empty_cache()
    return launches


#: the card's fp16 logits against the CPU's, teacher-forced
#: (``phase_serve_fp16_card_vs_cpu``): a multiple of the ulp of the row's
#: largest magnitude (fp16: 2^-10 of it)
SERVE_FP16_LOGIT_ULPS = 16


def phase_serve_fp16_card_vs_cpu() -> None:
    """A small GPT (2 layers, hidden 128) in fp16 serves one request (a
    prompt of 64, 9 new tokens: the prefill's token and 8 decode steps) on
    the paged and the flat layout, first on the CPU (greedy), then on the
    card teacher-forced on the CPU's tokens (the engine's token choice
    replaced by the CPU's), so that both see the same inputs at every
    position. The card's logits (Kernel B in the prefill, C in each paged
    decode step) must lie within ``SERVE_FP16_LOGIT_ULPS`` fp16 ulps of
    the row's largest magnitude of the CPU's: both round each op once to
    fp16 but sum in other orders (cuBLAS's fp16 GEMMs, the kernels' fp32
    p against the plain versions' rounded p), so a value near a rounding
    boundary lands one fp16 step away and the steps compound over two
    layers, the LM head's 128-term dots and the decode steps' caches. The
    argmax must agree wherever the CPU's top-two margin exceeds that
    tolerance. Greedy tokens are not compared: where two logits tie
    closer than one rounding, the card may choose the other."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**SMALL, compute_dtype=torch.float16)
    keep = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    try:
        for layout in ("paged", "flat"):
            ecfg = EngineConfig(max_slots=1, max_len=128, page_size=16,
                                prefix_cache=False, kv_layout=layout)
            seen, tokens = {}, {}
            for device in ("cpu", "cuda"):
                model = GPTModel(cfg, device=device,
                                 generator=torch.Generator().manual_seed(0))
                engine = InferenceEngine(model, ecfg, device=device)
                rows, forced = [], tokens.get("cpu")
                pick = engine._pick

                def teacher(logits, *args, _pick=pick, _rows=rows,
                            _forced=forced):
                    _rows.append(logits.float().cpu())
                    out = _pick(logits, *args)
                    if _forced is not None:
                        out = torch.full_like(out, _forced[len(_rows) - 1])
                    return out

                engine._pick = teacher
                req = _requests(1, cfg.vocab_size, 9, 4)[0]
                res = engine.serve([req])[0]
                if res.finish_reason not in ("length", "eos"):
                    raise AssertionError(f"serve_fp16_card_vs_cpu {layout} "
                                         f"on {device}: {res.finish_reason}")
                seen[device], tokens[device] = torch.cat(rows), res.tokens
            want, got = seen["cpu"], seen["cuda"]
            if got.shape != want.shape or tokens["cuda"] != tokens["cpu"]:
                raise AssertionError(f"serve_fp16_card_vs_cpu {layout}: "
                                     f"{tuple(got.shape)} vs "
                                     f"{tuple(want.shape)} logits, tokens "
                                     f"{tokens}")
            mag = want.abs().amax(dim=-1, keepdim=True)
            tol = SERVE_FP16_LOGIT_ULPS * torch.exp2(
                torch.floor(torch.log2(mag)) - 10)
            ratio = float(((got - want).abs() / tol).max())
            top2 = want.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol[:, 0]
            agree = got.argmax(-1) == want.argmax(-1)
            log("serve_fp16_card_vs_cpu", layout=layout, positions=len(want),
                max_abs_err=f"{float((got - want).abs().max()):.3e}",
                max_err_over_tol=f"{ratio:.3f}",
                tol=f"{SERVE_FP16_LOGIT_ULPS}_fp16_ulps_of_row_max",
                clear_margins=int(clear.sum()),
                argmax_agree_where_clear=bool(agree[clear].all()),
                argmax_agree=int(agree.sum()), finite=bool(
                    torch.isfinite(got).all()))
            if ratio > 1.0 or not agree[clear].all() or \
                    not torch.isfinite(got).all():
                raise AssertionError(
                    f"serve_fp16_card_vs_cpu {layout}: logits at {ratio} of "
                    f"the tolerance, argmax where clear "
                    f"{agree[clear].tolist()}")
    finally:
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            keep


def phase_serving_paths_card_vs_cpu(seed: int) -> None:
    """A small f32 GPT (TF32 off, set in ``main``) serves the same requests
    on the card and on the CPU through each new serving path: sampled
    paged decode, sampled speculation, chunked prefill on both layouts, a
    priority preemption whose continuation the supervisor resubmits, and a
    supervisor restart. The tokens must be equal."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                        InferenceEngine, Request,
                                        SamplingParams, SchedulerConfig)
    from apex_tpu_torch.testing_faults import ServingFaultInjector
    cfg = TransformerConfig(**SMALL)
    base = dict(max_slots=4, max_len=128, page_size=16)

    def engine_run(knobs):
        def run(model, device, reqs):
            eng = InferenceEngine(model, EngineConfig(**base, **knobs),
                                  device=device)
            return eng.serve(reqs), eng.metrics.counters()
        return run

    def restart_run(model, device, reqs):
        sup = EngineSupervisor(model, EngineConfig(**base), device=device,
                               faults=ServingFaultInjector(
                                   decode_raise_calls={3},
                                   prefill_raise_calls={2}))
        return sup.serve(reqs), sup.metrics.counters()

    def preempt_run(model, device, reqs):
        sup = EngineSupervisor(model, EngineConfig(
            **dict(base, max_slots=1), scheduler=SchedulerConfig(
                max_queue=8, max_prefills_per_tick=1)), device=device)
        victim = Request(prompt=list(reqs[1].prompt), max_new_tokens=12,
                         sampling=SamplingParams(
                             temperature=0.9, top_k=8, seed=seed + 5,
                             priority="batch"))
        head = Request(prompt=list(reqs[0].prompt), max_new_tokens=4,
                       sampling=SamplingParams(priority="interactive"))
        sup.submit(victim)
        while not sup.engine._active or len(
                next(iter(sup.engine._active.values())).tokens) < 3:
            sup.tick()
        sup.submit(head)
        while sup.inflight_count:
            sup.tick()
        return [sup.completed[victim.request_id],
                sup.completed[head.request_id]], sup.metrics.counters()

    cases = [("sampled_paged", engine_run({}), {}),
             ("sampled_speculation", engine_run(dict(speculation=3)),
              {"draft_tokens_accepted": 1}),
             ("chunked_paged", engine_run(dict(prefill_token_budget=32)),
              {"prefill_chunks": 7}),
             ("chunked_flat", engine_run(dict(kv_layout="flat",
                                              prefill_token_budget=24)),
              {"prefill_chunks": 7}),
             ("preemption", preempt_run,
              {"requests_preempted": 1, "requests_resumed": 1}),
             ("restart", restart_run, {"engine_restarts": 2})]
    for name, run, least in cases:
        out = {}
        for device in ("cuda", "cpu"):
            model = GPTModel(cfg, device=device,
                             generator=torch.Generator().manual_seed(0))
            reqs = _with_sampling(_prefix_requests(
                6, cfg.vocab_size, 10, 4, prefix_len=48, suffix=(4, 40)),
                seed)
            results, counters = run(model, device, reqs)
            if any(r.finish_reason not in ("length", "eos")
                   for r in results):
                raise AssertionError(f"{name} on {device}: "
                                     f"{[r.finish_reason for r in results]}")
            short = {k: counters[k] for k in least if counters[k] < least[k]}
            if short:
                raise AssertionError(f"{name} on {device}: counters {short} "
                                     f"below {least}")
            out[device] = [r.tokens for r in results]
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"card vs CPU tokens differ on {name}: "
                                 f"{out}")
        log("serving_paths_card_vs_cpu", path=name, requests=len(out["cuda"]),
            tokens=sum(map(len, out["cuda"])), equal=True)


def phase_card_vs_cpu() -> None:
    """Runs with TF32 off (set in ``main``), so the card's f32 GEMMs are
    f32 as on the CPU."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**GPT2)                       # f32 throughout
    ecfg = EngineConfig(max_slots=1, max_len=128, page_size=64,
                        prefix_cache=False)
    out = {}
    for device in ("cuda", "cpu"):
        model = GPTModel(cfg, device=device,
                         generator=torch.Generator().manual_seed(0))
        req = _requests(1, cfg.vocab_size, 8, 4)[0]
        out[device] = InferenceEngine(model, ecfg, device=device).serve(
            [req])[0].tokens
    if out["cuda"] != out["cpu"] or len(out["cuda"]) != 8:
        raise AssertionError(f"card vs CPU greedy tokens differ: {out}")
    log("card_vs_cpu", prompt_len=64, tokens=out["cuda"], equal=True)


def _train_model(cfg, device, seed=0, lr=1e-4):
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    model = GPTModel(cfg, device=device,
                     generator=torch.Generator().manual_seed(seed))
    opt = FusedAdam(model.parameters(), lr=lr)
    step = make_train_step(lambda batch: model(*batch), opt)
    step.optimizer = opt
    return model, step


def _train_batch(cfg, b, s, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    return tokens.to(device), labels.to(device)


def transformer_train_flops(n_params, tokens, num_layers, hidden, seq,
                            causal) -> float:
    """Model FLOPs of one training step (``apex_tpu/utils/flops.py:44-50``):
    ``6 N`` per token plus the attention term ``12 L s h`` per token,
    halved for causal masking."""
    attn = 12 * num_layers * seq * hidden * (0.5 if causal else 1.0)
    return float(tokens) * (6.0 * n_params + attn)


def _timed_steps(step, batch) -> tuple:
    """2 warm-up and 8 timed steps, the launch counters read over all ten:
    ``(losses, step seconds, launches, peak GB)``."""
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return ([float(x) for x in losses], times, dict(LAUNCHES),
            torch.cuda.max_memory_allocated() / 1e9)


def _report_train(phase, model_name, losses, times, launches, peak_gb,
                  per_step, tokens, flops, positions=None, unit="tokens",
                  **extra) -> None:
    """Print the phase's line; raise unless every loss is finite, the last
    below the first, and every kernel launched ``per_step`` times a step
    (0 for a kernel not listed). ``tokens`` are the tokens (or, with
    ``unit``, the images) a step trains (padding left out); ``positions``
    (if padded) and ``flops`` count every position the step computes,
    padding included."""
    steps = len(losses)
    timed = sorted(times[WARMUP_STEPS:])
    step_s = timed[len(timed) // 2]
    log(phase, model=model_name, steps=steps,
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""),
        step_ms_median=f"{1e3 * step_s:.2f}",
        step_ms=json.dumps([round(1e3 * t, 2) for t in times]).replace(
            " ", ""),
        **{f"{unit}_per_s": f"{tokens / step_s:.1f}"},
        **({} if positions is None
           else dict(positions_per_s=f"{positions / step_s:.1f}")),
        mfu=f"{flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f}",
        peak_mem_gb=f"{peak_gb:.3f}", **extra,
        launches=json.dumps(launches).replace(" ", ""))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall on the fixed "
                             f"batch: {losses}")
    want = {k: per_step.get(k, 0) * steps for k in ALL_KERNELS}
    if launches != want:
        raise AssertionError(f"{phase}: launches over {steps} steps "
                             f"{launches}, expected {want}")


def phase_train(profile: bool = False) -> dict:
    """GPT-2 124M trains in the bench.py configuration: returns the
    kernels' launches over the phase. With ``profile``, two more steps run
    under the profiler once the counts are read."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**GPT2, hidden_dropout=0.0, attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _train_model(cfg, "cuda")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, times, launches, peak = _timed_steps(step, batch)
    per_step = dict(TRAIN_KERNELS,
                    **optimizer_launches_per_step(step.optimizer))
    _report_train("train", "gpt2-124m bf16/fp32 random-init", losses, times,
                  launches, peak, per_step, tokens,
                  transformer_train_flops(n_params, tokens,
                                          GPT2["num_layers"],
                                          GPT2["hidden_size"], TRAIN_SEQ,
                                          causal=True),
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_params=n_params)
    report_optimizer("train", step.optimizer)
    if profile:
        profile_device("train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=TRAIN_BATCH,
                                    seq=TRAIN_SEQ))
    return launches


def _train_then_serve(prefix: str, widths: dict, batch_size: int, seq: int,
                      kernels: dict, model_name: str, profile: bool,
                      **fields) -> dict:
    """A GPT at ``widths`` (bf16 compute over fp32 params, weights from a
    seed; the init's seconds printed) takes 2 + 8 steps of
    ``make_train_step`` with FusedAdam lr 1e-4 at ``batch_size`` x ``seq``
    (``[{prefix}_train]``: the kernels launched ``kernels`` times a step,
    the rest 0; the loss falls), then, with the optimizer's state dropped,
    serves 8 greedy requests of ``PROMPT_LENS`` prompts and 32 new tokens
    in bf16 through ``InferenceEngine`` with pages of 64
    (``[{prefix}_serve]``: every request ends ``length``/``eos``, A > 0, B
    a layer a prefill, C a layer a decode step, every one of its launches
    on the vector path by the plans it took (``DECODE_PLANS``, printed
    with their counts), every other kernel 0). Returns the launches of
    both paths."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.ops._support import DECODE_PLANS
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    torch.cuda.empty_cache()
    cfg = TransformerConfig(**widths, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, step = _train_model(cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = _train_batch(cfg, batch_size, seq, "cuda")
    tokens = batch_size * seq
    losses, times, launches, peak = _timed_steps(step, batch)
    per_step = dict(kernels, **optimizer_launches_per_step(step.optimizer))
    card = _card_name().replace(" ", "_")
    _report_train(f"{prefix}_train", f"{model_name} bf16/fp32 random-init",
                  losses, times, launches, peak, per_step, tokens,
                  transformer_train_flops(n_params, tokens,
                                          widths["num_layers"],
                                          widths["hidden_size"], seq,
                                          causal=True),
                  batch=batch_size, seq=seq, n_params=n_params,
                  head_dim=cfg.head_dim, init_s=f"{init_s:.1f}", card=card,
                  **fields)
    report_optimizer(f"{prefix}_train", step.optimizer)
    if profile:
        profile_device(f"{prefix}_train",
                       lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=batch_size, seq=seq))
    paths = {f"{prefix}_train": launches}
    del step, batch
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64,
                        prefix_cache=False)
    InferenceEngine(model, ecfg).serve(_requests(2, cfg.vocab_size, 4, 9))
    engine = InferenceEngine(model, ecfg)
    requests = _requests(8, cfg.vocab_size, 32, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plans = dict(LAUNCHES), dict(DECODE_PLANS)
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != 8 or bad:
        raise AssertionError(f"{prefix}_serve: {len(results)} results, bad "
                             f"finish reasons {bad}")
    counters = engine.metrics.counters()
    steps, prefills = counters["decode_steps"], counters["prefills"]
    want = {k: 0 for k in ALL_KERNELS}
    want.update(flash_fwd=widths["num_layers"] * prefills,
                paged_decode=widths["num_layers"] * steps,
                layer_norm_fwd=launches["layer_norm_fwd"])
    if launches != want or launches["layer_norm_fwd"] <= 0:
        raise AssertionError(f"{prefix}_serve: launches {launches}, "
                             f"expected {want} (A > 0)")
    # the plans C's launches took in this run: all on the vector path
    vector = sum(n for p, n in plans.items() if p.path == "vector")
    if vector != launches["paged_decode"]:
        raise AssertionError(f"{prefix}_serve: {vector} of C's "
                             f"{launches['paged_decode']} launches on the "
                             f"vector path, plans {plans}")
    n_tok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results)
    step_h = engine.metrics.histogram("decode_step_s")
    log(f"{prefix}_serve", model=f"{model_name} bf16 random-init",
        requests=8,
        tokens=n_tok, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{n_tok / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}",
        decode_ms_per_step=f"{1e3 * step_h.sum / step_h.count:.3f}",
        decode_steps=steps, prefills=prefills,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        c_vector=vector, c_pieces=",".join(sorted({str(p.pieces)
                                                   for p in plans})),
        c_plans=",".join(f"{_decode_plan_text(p)}x{n}"
                         for p, n in sorted(plans.items())), card=card,
        launches=json.dumps(launches).replace(" ", ""))
    if profile:
        profile_serve(model, ecfg)
    paths[f"{prefix}_serve"] = launches
    del engine, model
    torch.cuda.empty_cache()
    return paths


def phase_gemma2b(profile: bool = False) -> dict:
    """A GPT at Gemma-2B's widths and depth (:data:`GEMMA`) trains at b 2,
    s 1024 (``[gemma2b_train]``: Kernels A, D, E and F launched 37, 37, 18
    and 18 times a step, B and I 0) and serves 8 requests
    (``[gemma2b_serve]``: A, B at head_dim 256 for the prefills, C at
    head_dim 256 with 8 query rows over one K/V head for the decode
    steps), as :func:`_train_then_serve` says. Returns the launches of
    both paths."""
    return _train_then_serve("gemma2b", GEMMA, GEMMA_BATCH, GEMMA_SEQ,
                             GEMMA_KERNELS, "gemma-2b-widths", profile)


def _small_card_vs_cpu(phase: str, widths: dict, page_size: int,
                       prompts: tuple) -> None:
    """A tiny f32 GPT at ``widths`` (TF32 off) trains 3 steps on the card
    and on the CPU: losses and step-1 gradients to ``_card_vs_cpu``'s bar;
    then serves greedy requests of ``prompts`` tokens through the engine
    on both with pages of ``page_size``: the tokens are equal."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request
    cfg = TransformerConfig(**widths)

    def build(device):
        model, step = _train_model(cfg, device, seed=2)
        return model, step, _train_batch(cfg, 2, 64, device, seed=3)

    _card_vs_cpu(phase, build, layers=cfg.num_layers,
                 hidden=cfg.hidden_size, head_dim=cfg.head_dim)
    g = torch.Generator().manual_seed(5)
    out = {}
    for device in ("cuda", "cpu"):
        model = GPTModel(cfg, device=device,
                         generator=torch.Generator().manual_seed(0))
        reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                             generator=g.manual_seed(n))
                        .tolist(), max_new_tokens=8) for n in prompts]
        eng = InferenceEngine(model, EngineConfig(
            max_slots=4, max_len=128, page_size=page_size,
            prefix_cache=False), device=device)
        out[device] = [r.tokens for r in eng.serve(reqs)]
    if out["cuda"] != out["cpu"] or any(len(t) != 8 for t in out["cuda"]):
        raise AssertionError(f"{phase}: greedy tokens differ: {out}")
    log(phase, serve="greedy", requests=len(prompts), page_size=page_size,
        tokens=json.dumps(out["cuda"]).replace(" ", ""), equal=True)


def phase_hd256_card_vs_cpu() -> None:
    """The tiny head_dim-256 GPT (:data:`HD256_SMALL`, f32) on the card
    (Kernels E and F at DMAX 256 in f32; B and C at head_dim 256 serving
    with pages of 16) and the CPU (:func:`_small_card_vs_cpu`)."""
    _small_card_vs_cpu("hd256_card_vs_cpu", HD256_SMALL, 16, (20, 37, 64))


def _bert_model(cfg, device, seed=0):
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.training import make_train_step
    model = BertModel(cfg, device=device,
                      generator=torch.Generator().manual_seed(seed))
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    step = make_train_step(lambda batch: model(*batch)[0], opt)
    step.optimizer = opt
    return model, step


def _bert_batch(cfg, b, s, device, seed):
    """Tokens, a padding mask with valid lengths in [s/2, s] (row 0 full),
    tokentype ids 0 before a seeded split inside each row's valid part and
    1 after, LM labels."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    lengths = _valid_lengths(b, s, seed + 1)
    split = (torch.rand(b, generator=g) * lengths).long().clamp_min(1)
    pos = torch.arange(s)[None, :]
    padding = pos < lengths[:, None]
    types = (pos >= split[:, None]).long()
    return tuple(t.to(device) for t in (tokens, padding, types, labels))


def phase_bert_train(profile: bool = False) -> dict:
    """BERT-base with padding masks and FusedLAMB: returns the launches."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.transformer.enums import AttnMaskType
    cfg = TransformerConfig(**BERT, hidden_dropout=0.0, attention_dropout=0.0,
                            attn_mask_type=AttnMaskType.padding,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _bert_model(cfg, "cuda")
    batch = _bert_batch(cfg, BERT_BATCH, BERT_SEQ, "cuda", seed=12)
    n_params = sum(p.numel() for p in model.parameters())
    positions = BERT_BATCH * BERT_SEQ
    tokens = int(batch[1].sum())
    losses, times, launches, peak = _timed_steps(step, batch)
    per_step = dict(BERT_KERNELS,
                    **optimizer_launches_per_step(step.optimizer))
    _report_train("bert_train", "bert-base bf16/fp32 random-init", losses,
                  times, launches, peak, per_step, tokens,
                  transformer_train_flops(n_params, positions,
                                          BERT["num_layers"],
                                          BERT["hidden_size"], BERT_SEQ,
                                          causal=False),
                  positions, batch=BERT_BATCH, seq=BERT_SEQ,
                  valid_tokens=tokens, n_params=n_params)
    report_optimizer("bert_train", step.optimizer)
    if profile:
        profile_device("bert_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=BERT_BATCH, seq=BERT_SEQ))
    return launches


def _t5_model(cfg, device, seed=0, lr=1e-4):
    from apex_tpu_torch.models import EncoderDecoderModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    model = EncoderDecoderModel(cfg, device=device,
                                generator=torch.Generator().manual_seed(seed))
    opt = FusedAdam(model.parameters(), lr=lr)
    step = make_train_step(
        lambda b: model(b[0], b[1], b[2], enc_lengths=b[3]), opt)
    step.optimizer = opt
    return model, step


def _t5_batch(cfg, b, s_enc, s_dec, device, seed):
    """Encoder and decoder tokens, decoder labels, encoder valid lengths
    in [s_enc/2, s_enc] (row 0 full)."""
    g = torch.Generator().manual_seed(seed)
    enc = torch.randint(0, cfg.vocab_size, (b, s_enc), generator=g)
    dec = torch.randint(0, cfg.vocab_size, (b, s_dec), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s_dec), generator=g)
    lengths = _valid_lengths(b, s_enc, seed + 1)
    return tuple(t.to(device) for t in (enc, dec, labels, lengths))


def enc_dec_train_flops(model, b, s_enc, s_dec) -> float:
    """Encoder tokens through the encoder's parameters (bidirectional
    attention), decoder tokens through the decoder's and the tied LM head's
    (causal self-attention, and cross-attention over ``s_enc`` keys: 12 L
    s_enc h a token), each as ``transformer_train_flops`` counts them."""
    c = model.config
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    n_dec = sum(p.numel() for p in model.decoder.parameters()) + \
        model.embedding.word_embeddings.weight.numel()
    cross = 12.0 * c.num_layers * s_enc * c.hidden_size * b * s_dec
    return (transformer_train_flops(n_enc, b * s_enc, c.num_layers,
                                    c.hidden_size, s_enc, causal=False)
            + transformer_train_flops(n_dec, b * s_dec, c.num_layers,
                                      c.hidden_size, s_dec, causal=True)
            + cross)


def phase_t5_train(profile: bool = False) -> dict:
    """The encoder-decoder at T5-base widths with enc_lengths: returns the
    launches."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**T5, hidden_dropout=0.0, attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _t5_model(cfg, "cuda")
    batch = _t5_batch(cfg, T5_BATCH, T5_ENC, T5_DEC, "cuda", seed=13)
    n_params = sum(p.numel() for p in model.parameters())
    positions = T5_BATCH * (T5_ENC + T5_DEC)
    tokens = int(batch[3].sum()) + T5_BATCH * T5_DEC
    losses, times, launches, peak = _timed_steps(step, batch)
    per_step = dict(T5_KERNELS,
                    **optimizer_launches_per_step(step.optimizer))
    _report_train("t5_train", "t5-base-widths enc-dec bf16/fp32 random-init",
                  losses, times, launches, peak, per_step, tokens,
                  enc_dec_train_flops(model, T5_BATCH, T5_ENC, T5_DEC),
                  positions, batch=T5_BATCH, enc_seq=T5_ENC, dec_seq=T5_DEC,
                  valid_tokens=tokens,
                  enc_lengths=json.dumps(batch[3].tolist()).replace(" ", ""),
                  n_params=n_params)
    report_optimizer("t5_train", step.optimizer)
    if profile:
        profile_device("t5_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=T5_BATCH, enc_seq=T5_ENC,
                                    dec_seq=T5_DEC))
    return launches


def _grad_tree(model):
    return {name: p.grad.detach().cpu().clone()
            for name, p in model.named_parameters()}


def _card_vs_cpu(phase, build, before=None, **fields) -> dict:
    """``build(device) -> (model, step, batch)`` from fixed seeds; three
    steps on the card (TF32 off, set in ``main``) and on the CPU. Losses
    agree to 1e-5 relative; every step-1 gradient leaf to atol 1e-5 + rtol
    1e-4 (fp32 sums in other orders, through the kernels on one side and
    the plain versions on the other). ``before(device, model)``, if given,
    runs on each fresh model first; its results come back by device."""
    losses, grads, first = {}, {}, {}
    for device in ("cuda", "cpu"):
        model, step, batch = build(device)
        if before is not None:
            first[device] = before(device, model)
        losses[device] = [float(step(batch))]
        grads[device] = _grad_tree(model)
        losses[device] += [float(step(batch)) for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    worst, worst_name = 0.0, None
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        excess = float(((got - want).abs() - 1e-4 * want.abs()).max())
        if excess > worst or worst_name is None:
            worst, worst_name = excess, name
    log(phase, **fields, steps=3,
        losses_cuda=json.dumps(losses["cuda"]).replace(" ", ""),
        losses_cpu=json.dumps(losses["cpu"]).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", grad_leaves=len(grads["cpu"]),
        worst_grad_excess=f"{worst:.2e}", worst_leaf=worst_name)
    if rel > 1e-5 or worst > 1e-5:
        raise AssertionError(
            f"{phase}: loss rel err {rel} (tolerance 1e-5), grad leaf "
            f"{worst_name} off by {worst} past atol 1e-5 + rtol 1e-4")
    return first


SMALL = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
             vocab_size=512, max_position_embeddings=128, hidden_dropout=0.0,
             attention_dropout=0.0)


def phase_train_card_vs_cpu() -> None:
    """A small f32 GPT trains 3 steps on the card and on the CPU."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**SMALL)

    def build(device):
        model, step = _train_model(cfg, device, seed=2)
        return model, step, _train_batch(cfg, 4, 96, device, seed=3)

    _card_vs_cpu("train_card_vs_cpu", build, layers=2, hidden=128)


def phase_enc_card_vs_cpu() -> None:
    """A small f32 BERT (padding mask, LAMB) and a small f32
    encoder-decoder (enc_lengths, Adam) train 3 steps on the card and on
    the CPU."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.transformer.enums import AttnMaskType
    bert = TransformerConfig(**SMALL, attn_mask_type=AttnMaskType.padding)
    t5 = TransformerConfig(**SMALL, normalization="rmsnorm",
                           activation="relu")

    def build_bert(device):
        model, step = _bert_model(bert, device, seed=4)
        return model, step, _bert_batch(bert, 4, 96, device, seed=5)

    def build_t5(device):
        model, step = _t5_model(t5, device, seed=6, lr=1e-3)
        return model, step, _t5_batch(t5, 4, 96, 40, device, seed=7)

    _card_vs_cpu("enc_card_vs_cpu", build_bert, model="bert_padding_lamb",
                 layers=2, hidden=128)
    _card_vs_cpu("enc_card_vs_cpu", build_t5,
                 model="enc_dec_enc_lengths_adam", layers=2, hidden=128)


def _rn50_model(cfg_kw, device, seed=0, master_weights=False):
    """ResNet with weights from ``seed``, trained with cross entropy on
    the fp32 logits (benchmarks/rn50_dp.py's loss) and FusedSGD as
    rn50_dp configures it."""
    from apex_tpu_torch.models import ResNet, ResNetConfig
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.training import make_train_step
    model = ResNet(ResNetConfig(**cfg_kw), device=device,
                   generator=torch.Generator().manual_seed(seed))
    opt = FusedSGD(model.parameters(), lr=0.1, momentum=0.9,
                   weight_decay=1e-4, master_weights=master_weights)
    step = make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
    step.optimizer = opt
    return model, step


def _rn50_batch(b, size, classes, device, seed):
    """NHWC images and labels from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, size, size, 3, generator=g)
    y = torch.randint(0, classes, (b,), generator=g)
    return x.to(device), y.to(device)


def phase_rn50_train(profile: bool = False) -> dict:
    """ResNet-50 on the fused conv + batch-norm path: returns the
    launches."""
    from apex_tpu_torch.utils.flops import resnet50_train_flops
    cfg = dict(depth=50, num_classes=1000, compute_dtype=torch.bfloat16,
               fused_conv=True)
    model, step = _rn50_model(cfg, "cuda", master_weights=True)
    batch = _rn50_batch(RN50_BATCH, RN50_SIZE, 1000, "cuda", seed=14)
    n_params = sum(p.numel() for p in model.parameters())
    losses, times, launches, peak = _timed_steps(step, batch)
    per_step = dict(RN50_KERNELS,
                    **optimizer_launches_per_step(step.optimizer))
    _report_train("rn50_train", "resnet50 bf16/fp32 fused_conv random-init",
                  losses, times, launches, peak, per_step, RN50_BATCH,
                  resnet50_train_flops(RN50_BATCH, RN50_SIZE), unit="images",
                  batch=RN50_BATCH, image=RN50_SIZE, n_params=n_params)
    report_optimizer("rn50_train", step.optimizer)
    if profile:
        profile_device("rn50_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=RN50_BATCH,
                                    image=RN50_SIZE))
    return launches


def _leaf_norm(t) -> float:
    return float(t.double().norm())


def _rn50_blocks_card_vs_cpu(cfg) -> None:
    """Two fused bottlenecks of the model, where the gradient is well
    conditioned: layer1.1 (Kernels J, L, K, M) and layer2.0 (stride 2 with
    the downsample: J and K beside cuDNN's conv2). Output, new batch-norm
    buffers and the gradients of the input and every parameter agree to
    2e-5 of each leaf's largest magnitude (+ 1e-6 for the buffers)."""
    worst = 0.0
    for si, bi in ((0, 1), (1, 0)):
        got = {device: _rn50_block_leaves(cfg, device, si, bi, torch.float32)
               for device in ("cuda", "cpu")}
        for n, want in got["cpu"].items():
            atol = 1e-6 if n.startswith("buffer") else 0.0
            err = float((got["cuda"][n] - want).abs().max())
            ratio = err / (2e-5 * float(want.abs().max()) + atol + 1e-30)
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"rn50_card_vs_cpu: block layer{si + 1}.{bi} leaf {n} "
                    f"off by {err} (2e-5 of max {float(want.abs().max())})")
    log("rn50_card_vs_cpu", part="fused_blocks_layer1.1_layer2.0",
        leaves_per_block=len(got["cpu"]), worst_over_tol=f"{worst:.3f}")


def _rn50_block_leaves(cfg, device, si, bi, dtype):
    """Fused block ``layer{si + 1}.{bi}`` of ``_rn50_model(cfg)`` (seed 3)
    on a seeded [4, 8, 8, C] input (on the fp16 grid, so that every dtype
    starts from the same values) in ``dtype`` and a seeded cotangent:
    {leaf: fp32 CPU tensor} of its output, the input and parameter
    gradients and the new batch-norm buffers."""
    model, _ = _rn50_model(dict(cfg, compute_dtype=dtype), device, seed=3)
    blk = model.stages()[si][bi]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 8, 8, blk.conv1.shape[2], generator=g)
    hw = 8 // blk.stride
    r = torch.randn(4, hw, hw, blk.conv3.shape[3], generator=g)
    xt = x.half().to(device=device, dtype=dtype).requires_grad_()
    out = model._block_apply_fused(blk, xt)
    (out.float() * r.to(device)).sum().backward()
    leaves = {"out": out, "grad x": xt.grad}
    leaves.update({f"grad {n}": p.grad for n, p in blk.named_parameters()})
    leaves.update({f"buffer {n}": b for n, b in blk.named_buffers()})
    return {n: t.detach().float().cpu().clone() for n, t in leaves.items()}


def _rn50_fp16_card_vs_cpu(cfg) -> None:
    """fp16 parts of ``phase_rn50_card_vs_cpu`` (``compute_dtype=
    float16``, fp32 params): 0. the two fused blocks in fp16 on the card
    and on the CPU, each leaf held to its distance from the CPU's f32
    block: the card's at most twice the CPU's fp16 one, plus 1e-6 of the
    leaf's norm (both round at the same fp16 points, in other fp32 sum
    orders, and the batch-norm backward's cancellations amplify a flipped
    rounding to 1-4% norm-wise on either side; a bf16 rounding, or a moved
    rounding point, lands several times further). 2. three FusedSGD steps
    (lr 0.01, the recipe's init) under amp O2's dynamic scale with an inf
    injected after the backward of step 1: the scaler walks equal, the
    skipped step leaves the card's parameters and momenta bitwise
    unchanged, and the losses within ``AMP_FP16_LOSS_RTOL`` (measured on
    the CPU: fp16 runs on inputs perturbed by 1e-3 part at 5e-4 of each
    other, fp16 and f32 at 4e-3), on two inputs (``RN50_FP16_SEEDS``),
    each logged beside the CPU's fp16-vs-f32 gap on that input."""
    worst = 0.0
    for si, bi in ((0, 1), (1, 0)):
        ref = _rn50_block_leaves(cfg, "cpu", si, bi, torch.float32)
        cpu = _rn50_block_leaves(cfg, "cpu", si, bi, torch.float16)
        card = _rn50_block_leaves(cfg, "cuda", si, bi, torch.float16)
        for n, want in ref.items():
            norm = float(want.norm())
            e_card = float((card[n] - want).norm())
            e_cpu = float((cpu[n] - want).norm())
            ratio = e_card / (2.0 * e_cpu + 1e-6 * norm + 1e-30)
            worst = max(worst, ratio)
            if ratio > 1.0 or not torch.isfinite(card[n]).all():
                raise AssertionError(
                    f"rn50_card_vs_cpu fp16: block layer{si + 1}.{bi} leaf "
                    f"{n}: card {e_card / norm:.3e} from the f32 block, CPU "
                    f"fp16 {e_cpu / norm:.3e} (at most twice)")
    log("rn50_card_vs_cpu", part="fused_blocks_fp16_layer1.1_layer2.0",
        leaves_per_block=len(ref), worst_over_tol=f"{worst:.3f}")
    cfg3 = dict(cfg, zero_init_residual=True, compute_dtype=torch.float16)
    for seed in RN50_FP16_SEEDS:
        _rn50_fp16_three_steps(cfg3, seed)


#: the inputs (``_rn50_batch`` seeds) of the fp16 three-step comparison
RN50_FP16_SEEDS = (15, 16)


def _rn50_amp_three_steps(cfg3, device, x, y) -> tuple:
    """Three FusedSGD steps (lr 0.01) of ``cfg3``'s ResNet under amp O2's
    fp16 dynamic scale, an inf injected after the backward of step 1:
    (losses, scaler states, the skipped step left parameters and momenta
    bitwise unchanged)."""
    from apex_tpu_torch import amp
    model, step = _rn50_model(cfg3, device, seed=3)
    opt = step.optimizer
    for group in opt.param_groups:
        group["lr"] = 0.01
    state = amp.initialize("O2", half_dtype=torch.float16, device=device)
    sc, ss = state.scaler, state.scaler_states[0]
    params = list(model.parameters())
    losses, walk, unchanged = [], [], None
    for i in range(3):
        before = _cpu_snapshot(params + [
            v for p in params for v in opt.state.get(p, {}).values()
            if isinstance(v, torch.Tensor)]) if i == 1 else None
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x.to(device)), y.to(device))
        amp.scale_loss(loss, ss).backward()
        if i == 1:
            model.fc.kernel.grad[0, 0] = float("inf")
        _, found = sc.unscale([p.grad for p in params], ss)
        opt.step(found_inf=found)
        ss = sc.update(ss, found)
        losses.append(float(loss.detach()))
        walk.append(sc.state_dict(ss))
        if before is not None:
            unchanged = _all_equal(before, _cpu_snapshot(params + [
                v for p in params for v in opt.state[p].values()
                if isinstance(v, torch.Tensor)]))
    return losses, walk, unchanged


def _rn50_fp16_three_steps(cfg3, seed) -> float:
    """Part 2 of ``_rn50_fp16_card_vs_cpu`` on the input from ``seed``:
    the card's fp16 losses against the CPU's, beside the CPU's fp16
    losses against its f32 ones on the same input (the gap that a
    computation in the wrong type would open); returns the first."""
    x, y = _rn50_batch(4, 64, 8, "cpu", seed=seed)
    lc, wc, uc = _rn50_amp_three_steps(cfg3, "cuda", x, y)
    lh, wh, _ = _rn50_amp_three_steps(cfg3, "cpu", x, y)
    l32, _, _ = _rn50_amp_three_steps(
        dict(cfg3, compute_dtype=torch.float32), "cpu", x, y)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    rel32 = max(abs(a - b) / abs(b) for a, b in zip(lh, l32))
    log("rn50_card_vs_cpu", part="three_sgd_steps_fp16_amp_o2", lr=0.01,
        input_seed=seed, injected_step=1,
        losses_cuda=json.dumps(lc).replace(" ", ""),
        losses_cpu=json.dumps(lh).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", loss_rtol=AMP_FP16_LOSS_RTOL,
        cpu_fp16_vs_f32_rel=f"{rel32:.2e}",
        loss_scale=json.dumps([w["loss_scale"] for w in wc]).replace(
            " ", ""), scaler_equal=wc == wh, skipped_step_unchanged=uc)
    if rel > AMP_FP16_LOSS_RTOL or wc != wh or not uc or \
            wc[1]["loss_scale"] != wc[0]["loss_scale"] / 2:
        raise AssertionError(
            f"rn50_card_vs_cpu fp16: input {seed}: loss rel err {rel} "
            f"({AMP_FP16_LOSS_RTOL}), scalers {wc} vs {wh}, skipped step "
            f"unchanged {uc}")
    return rel


def phase_rn50_card_vs_cpu() -> None:
    """ResNet-50 at 64 px, batch 4, 8 classes, f32 (TF32 off), on the card
    and on the CPU from one seed. Kernels K and M are decided by
    ``phase_conv``'s checks at the main path's shapes and by part 0 here;
    parts 1 and 2 check the model's wiring, since the whole model's
    gradient is too chaotic to catch a dW that is off by a few percent.

    0. Two fused blocks in isolation (``_rn50_blocks_card_vs_cpu``), to
       2e-5 of each leaf's largest magnitude.
    1. ``zero_init_residual=False``, one step: the loss to rtol 2e-4, the
       batch-norm buffers to 1e-3 of each leaf's largest magnitude + 1e-5.
       This model's f32 gradient is chaotic at batch 4 (a 1e-7 relative
       perturbation of the input moves it by ~2% of its norm), so each
       gradient leaf is held within 8x, and the whole tree within 3x, the
       largest change that three such perturbations make on the CPU (or
       1e-5 of the leaf's norm).
    2. The recipe's ``zero_init_residual=True``, three FusedSGD steps: the
       losses to rtol 1e-4, then every parameter and buffer to 1e-4 of its
       leaf's largest magnitude + 1e-6.
    Then parts 0 and 2 in fp16 (``_rn50_fp16_card_vs_cpu``)."""
    cfg = dict(depth=50, num_classes=8, fused_conv=True,
               zero_init_residual=False)
    _rn50_blocks_card_vs_cpu(cfg)
    x, y = _rn50_batch(4, 64, 8, "cpu", seed=15)

    def one_step(device, xx):
        model, _ = _rn50_model(cfg, device, seed=3)
        loss = F.cross_entropy(model(xx.to(device)), y.to(device))
        loss.backward()
        return (float(loss.detach()), _grad_tree(model),
                {n: b.detach().cpu().clone()
                 for n, b in model.named_buffers()})

    loss_c, grads_c, bufs_c = one_step("cuda", x)
    loss_h, grads_h, bufs_h = one_step("cpu", x)
    floors = []
    for seed in (9, 10, 11):
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed))
        floors.append(one_step("cpu", x * (1 + 1e-7 * noise))[1])
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    buf_excess = max(float((bufs_c[n] - v).abs().max()
                           - 1e-3 * v.abs().max() - 1e-5)
                     for n, v in bufs_h.items())
    worst_ratio, worst_leaf = 0.0, None
    for n, want in grads_h.items():
        floor = max(_leaf_norm(f[n] - want) for f in floors)
        ratio = _leaf_norm(grads_c[n] - want) / max(
            floor, 1e-5 * _leaf_norm(want), 1e-30)
        if ratio >= worst_ratio:
            worst_ratio, worst_leaf = ratio, n
    tree = math.sqrt(sum(_leaf_norm(grads_c[n] - v) ** 2
                         for n, v in grads_h.items()))
    tree_floor = max(math.sqrt(sum(_leaf_norm(f[n] - v) ** 2
                                   for n, v in grads_h.items()))
                     for f in floors)
    log("rn50_card_vs_cpu", part="step1_zero_init_residual_false",
        image=64, batch=4, loss_cuda=f"{loss_c:.7f}", loss_cpu=f"{loss_h:.7f}",
        loss_rel_err=f"{loss_rel:.2e}", grad_leaves=len(grads_h),
        worst_leaf_over_floor=f"{worst_ratio:.3f}", worst_leaf=worst_leaf,
        tree_err=f"{tree:.3e}", tree_floor=f"{tree_floor:.3e}",
        buffer_excess=f"{buf_excess:.2e}")
    if loss_rel > 2e-4 or worst_ratio > 8.0 or tree > 3 * tree_floor \
            or buf_excess > 0:
        raise AssertionError(
            f"rn50_card_vs_cpu: loss rel {loss_rel} (2e-4), leaf "
            f"{worst_leaf} at {worst_ratio}x its noise floor (8x), tree "
            f"{tree} vs floor {tree_floor} (3x), buffers {buf_excess} past "
            f"1e-3 rel + 1e-5")
    cfg3 = dict(cfg, zero_init_residual=True)
    losses, states = {}, {}
    for device in ("cuda", "cpu"):
        model, step = _rn50_model(cfg3, device, seed=3)
        batch = (x.to(device), y.to(device))
        losses[device] = [float(step(batch)) for _ in range(3)]
        states[device] = {n: t.detach().cpu().clone()
                          for n, t in model.state_dict().items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    excess = max(float((states["cuda"][n].float() - v.float()).abs().max()
                       - 1e-4 * v.float().abs().max() - 1e-6)
                 for n, v in states["cpu"].items())
    log("rn50_card_vs_cpu", part="three_sgd_steps_zero_init_residual_true",
        losses_cuda=json.dumps(losses["cuda"]).replace(" ", ""),
        losses_cpu=json.dumps(losses["cpu"]).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", state_leaves=len(states["cpu"]),
        state_excess=f"{excess:.2e}")
    if rel > 1e-4 or excess > 0 or not losses["cuda"][-1] < \
            losses["cuda"][0]:
        raise AssertionError(f"rn50_card_vs_cpu: three steps, loss rel "
                             f"{rel} (1e-4), state excess {excess}")
    _rn50_fp16_card_vs_cpu(cfg)


#: the multi-tensor kernels (csrc/multi_tensor.cu): port-only, no Pallas
#: counterpart; each stands for a jnp function of the JAX package
MT_REPLACES = {"multi_tensor_scale": "apex_tpu/amp/scaler.py:86",
               "multi_tensor_l2norm": "apex_tpu/utils/tree.py:35",
               "multi_tensor_adam": "apex_tpu/optimizers/fused_adam.py:44",
               "multi_tensor_lamb": "apex_tpu/optimizers/fused_lamb.py:48",
               "multi_tensor_sgd": "apex_tpu/optimizers/fused_sgd.py:37"}
#: fp32 operations an element of each kernel (for the operations bound)
MT_FLOPS = {"multi_tensor_scale": 2, "multi_tensor_l2norm": 3,
            "multi_tensor_adam": 18, "multi_tensor_lamb": 24,
            "multi_tensor_sgd": 8}
#: [train_amp]: the step (counted from 0, inside the timed steps) whose
#: grads get an inf after the backward
AMP_INJECT_STEP = 5


def _param_shapes(kind: str) -> list:
    """The parameter shapes of GPT-2 124M, BERT-base or ResNet-50."""
    from apex_tpu_torch.models import (BertModel, GPTModel, ResNet,
                                       ResNetConfig, TransformerConfig)
    from apex_tpu_torch.transformer.enums import AttnMaskType
    gen = torch.Generator().manual_seed(0)
    if kind == "gpt2":
        model = GPTModel(TransformerConfig(**GPT2), device="cuda",
                         generator=gen)
    elif kind == "bert":
        model = BertModel(TransformerConfig(
            **BERT, attn_mask_type=AttnMaskType.padding), device="cuda",
            generator=gen)
    else:
        model = ResNet(ResNetConfig(depth=50, num_classes=1000),
                       device="cuda", generator=gen)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


def _mt_tensors(shapes, dtype, g, scale=1.0) -> list:
    return [(scale * torch.randn(s, device="cuda", generator=g)).to(dtype)
            for s in shapes]


def _clones(xs):
    return None if xs is None else [x.clone() for x in xs]


def _all_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _norm_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of fp32 norms in units of want's fp32 ulp."""
    w = want.float().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 23)
    return float(((got.float() - w).abs() / ulp).max())


def _mt_record(name, label, ms, plain, lib, n_bytes, elements, err,
               shape) -> dict:
    bms, by = bound_ms(n_bytes, MT_FLOPS[name] * elements, torch.float32)
    return dict(name=name, route="cuda",
                source="apex_tpu_torch/csrc/multi_tensor.cu",
                replaces=MT_REPLACES[name], shape=f"{label}: {shape}",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def _mt_scale_and_norm(timer, mt, shapes, dtype, g, label) -> tuple:
    """multi_tensor_scale and multi_tensor_l2norm over one list: scale
    bitwise its plain version (with an inf and a nan: found_inf set, both
    zeroed; a clean list: not set), the norms within 1e-6 of theirs (sum
    order) and bitwise repeatable. Timed at scale 1 (a no-op unscale)."""
    n = sum(math.prod(s) for s in shapes)
    esz = torch.tensor([], dtype=dtype).element_size()
    grads = _mt_tensors(shapes, dtype, g, 1000.0)
    grads[0].view(-1)[0] = float("inf")
    grads[-1].view(-1)[-1] = float("nan")
    want = _clones(grads)
    scale = torch.tensor(1024.0, device="cuda")
    cache = mt.TableCache()
    found = mt.multi_tensor_scale(grads, scale, cache=cache)
    wfound = mt.scale_plain(want, scale)
    clean = _mt_tensors(shapes[:3], dtype, g)
    ok = (bool(found) and bool(wfound) and _all_equal(grads, want)
          and not bool(mt.multi_tensor_scale(clean, scale)))
    one = torch.tensor(1.0, device="cuda")
    ms = timer(lambda: mt.multi_tensor_scale(grads, one, cache=cache))
    plain = timer(lambda: mt.scale_plain(grads, one), iters=5, warmup=1)
    # torch's amp unscale takes no bf16: time it over fp16 copies (the
    # same bytes)
    lib_dtype = torch.float16 if dtype == torch.bfloat16 else dtype
    lib_grads = [x.to(lib_dtype) for x in grads]
    found_f = torch.zeros(1, device="cuda")
    lib = timer(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        lib_grads, found_f, one.view(1)))
    del lib_grads
    log("multi_tensor", kernel="multi_tensor_scale", list=label,
        tensors=len(shapes), elements=n, dtype=str(dtype)[6:],
        bitwise=ok, found_inf=bool(found), ms=f"{ms:.5f}",
        plain_ms=f"{plain:.5f}", library_ms=f"{lib:.5f}",
        library_dtype=str(lib_dtype)[6:])
    if not ok:
        raise AssertionError(f"multi_tensor_scale {label}: not bitwise its "
                             f"plain version, or found_inf wrong")
    scale_rec = _mt_record("multi_tensor_scale", label, ms, plain, lib,
                           2 * n * esz, n, 0.0,
                           f"{len(shapes)} grads, {n} elements "
                           f"{str(dtype)[6:]}")
    ncache = mt.TableCache()
    total, per = mt.multi_tensor_l2norm(grads, per_tensor=True, cache=ncache)
    total2, per2 = mt.multi_tensor_l2norm(grads, per_tensor=True,
                                          cache=ncache)
    wt, wp = mt.l2norm_plain(grads)
    rel = max(rel_norm(per, wp), abs(float(total) / float(wt) - 1))
    ulps = max(_norm_ulps(per, wp), _norm_ulps(total.view(1), wt.view(1)))
    same = torch.equal(total, total2) and torch.equal(per, per2)
    ms = timer(lambda: mt.multi_tensor_l2norm(grads, cache=ncache))
    plain = timer(lambda: mt.l2norm_plain(grads), iters=5, warmup=1)
    lib = timer(lambda: torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads))))
    log("multi_tensor", kernel="multi_tensor_l2norm", list=label,
        tensors=len(shapes), elements=n, dtype=str(dtype)[6:],
        rel_norm=f"{rel:.2e}", ulps=f"{ulps:.1f}", repeat_bitwise=same,
        ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}", library_ms=f"{lib:.5f}")
    if rel > 1e-6 or not same:
        raise AssertionError(f"multi_tensor_l2norm {label}: rel {rel} "
                             f"(1e-6), repeat bitwise {same}")
    norm_rec = _mt_record("multi_tensor_l2norm", label, ms, plain, lib,
                          n * esz, n, float((total - wt).abs()),
                          f"{len(shapes)} grads, {n} elements "
                          f"{str(dtype)[6:]}, total and per tensor")
    return scale_rec, norm_rec


def _mt_optimizer(timer, mt, kind, shapes, dtype, master, g, label) -> dict:
    """Three steps of the Adam, LAMB or SGD kernel (the second with
    found_inf) against the plain version on the card: Adam and SGD
    bitwise, LAMB every state leaf within 1e-6 norm-wise; the found_inf
    step leaves every param, master, slot and step bitwise as it was. Then
    one step timed beside the plain version and the library's fused
    optimizer over the same tensors."""
    n = sum(math.prod(s) for s in shapes)
    psz = torch.tensor([], dtype=dtype).element_size()
    params = _mt_tensors(shapes, dtype, g, 0.05)
    slots = [[torch.zeros(s, device="cuda") for s in shapes]
             for _ in range(1 if kind == "sgd" else 2)]
    updates = [torch.empty(s, device="cuda") for s in shapes]
    steps = [torch.zeros((), dtype=torch.int32, device="cuda")
             for _ in shapes]
    masters = [p.float().clone() for p in params] if master else None
    q, qslots, qsteps = _clones(params), [_clones(x) for x in slots], \
        _clones(steps)
    qmasters, qupdates = _clones(masters), _clones(updates)
    cache, gcache = mt.TableCache(), mt.TableCache()
    if kind == "adam":
        kw = dict(lr=1e-4, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8,
                  adam_w_mode=True, bias_correction=True)

        def run(grads, p, sl, st, ms_, up, found, kernel):
            fn = mt.multi_tensor_adam if kernel else mt.adam_plain
            extra = dict(cache=cache) if kernel else {}
            fn(grads, p, sl[0], sl[1], st, ms_, found_inf=found, **kw,
               **extra)
    elif kind == "lamb":
        kw = dict(lr=1e-3, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-6,
                  adam_w_mode=True, bias_correction=True, grad_averaging=True,
                  max_grad_norm=1.0, trust_clip=False, always_adapt=False)

        def run(grads, p, sl, st, ms_, up, found, kernel):
            if kernel:
                gnorm, _ = mt.multi_tensor_l2norm(grads, cache=gcache)
                mt.multi_tensor_lamb(grads, p, sl[0], sl[1], up, st, ms_,
                                     gnorm=gnorm, found_inf=found,
                                     cache=cache, **kw)
            else:
                gnorm, _ = mt.l2norm_plain(grads)
                mt.lamb_plain(grads, p, sl[0], sl[1], up, st, ms_,
                              gnorm=gnorm, found_inf=found, **kw)
    else:
        kw = dict(lr=0.1, weight_decay=1e-4, momentum=0.9, dampening=0.0,
                  nesterov=False, wd_after_momentum=False)

        def run(grads, p, sl, st, ms_, up, found, kernel):
            fn = mt.multi_tensor_sgd if kernel else mt.sgd_plain
            extra = dict(cache=cache) if kernel else {}
            fn(grads, p, sl[0], st, ms_, found_inf=found, **kw, **extra)

    state = lambda: params + sum(slots, []) + steps + (masters or [])  # noqa
    unchanged = True
    for i in range(3):
        grads = _mt_tensors(shapes, dtype, g, 1.0)
        found = torch.tensor(i == 1, device="cuda")
        before = _clones(state()) if i == 1 else None
        run(grads, params, slots, steps, masters, updates, found, True)
        run(grads, q, qslots, qsteps, qmasters, qupdates, found, False)
        if before is not None:
            unchanged = _all_equal(before, state())
    got = params + sum(slots, []) + steps + (masters or [])
    want = q + sum(qslots, []) + qsteps + (qmasters or [])
    if kind == "lamb":
        # fp32 leaves norm-wise; a bf16 param is its master rounded, so an
        # ulp of the master on a rounding boundary flips it by one bf16 ulp
        err = max(rel_norm(a, b) for a, b in zip(got, want)
                  if a.numel() and a.dtype == torch.float32)
        ulps = max((ulps16(a, b) for a, b in zip(params, q)
                    if a.numel() and a.dtype == torch.bfloat16), default=0.0)
        ok = err <= 1e-6 and ulps <= 1.0 and _all_equal(steps, qsteps)
        tol = (f"fp32 leaves rel_norm 1e-6, bf16 params 1 ulp "
               f"({ulps:.0f} ulp)")
    else:
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want) if a.numel())
        ok = _all_equal(got, want)
        tol = "bitwise"
    grads = _mt_tensors(shapes, dtype, g, 1.0)
    ms = timer(lambda: run(grads, params, slots, steps, masters, updates,
                           None, True))
    plain = timer(lambda: run(grads, q, qslots, qsteps, qmasters, qupdates,
                              None, False), iters=5, warmup=1)
    lib = None
    if kind != "lamb":
        lp = [torch.nn.Parameter(p.clone()) for p in params]
        for p, x in zip(lp, grads):
            p.grad = x
        opt = (torch.optim.AdamW(lp, lr=1e-4, weight_decay=0.01, fused=True)
               if kind == "adam" else
               torch.optim.SGD(lp, lr=0.1, momentum=0.9, weight_decay=1e-4,
                               fused=True))
        lib = timer(opt.step)
        del lp, opt
    name = f"multi_tensor_{kind}"
    # g read; p read and written (or the master read and written and p
    # written); fp32 moments read and written
    n_bytes = n * (psz + (8 + psz if master else 2 * psz)
                   + 8 * len(slots))
    log("multi_tensor", kernel=name, list=label, tensors=len(shapes),
        elements=n, dtype=str(dtype)[6:], master=master,
        max_err=f"{err:.3e}", tol=tol.replace(" ", "_"), ok=ok,
        found_inf_unchanged=unchanged, ms=f"{ms:.5f}",
        plain_ms=f"{plain:.5f}",
        library_ms=None if lib is None else f"{lib:.5f}",
        launches_a_step=json.dumps(mt.optimizer_launches(
            [math.prod(s) for s in shapes], name)).replace(" ", ""))
    if not ok or not unchanged:
        raise AssertionError(f"{name} {label}: off its plain version by "
                             f"{err} ({tol}); found_inf step unchanged: "
                             f"{unchanged}")
    return _mt_record(name, label, ms, plain, lib, n_bytes, n, err,
                      f"{len(shapes)} tensors, {n} elements "
                      f"{str(dtype)[6:]} params"
                      + (", fp32 master" if master else ""))


def phase_multi_tensor(timer: Timer) -> list:
    """The five multi-tensor kernels over GPT-2 124M's parameter list (plus
    a 1-element tensor and one of CHUNK + 1) with fp32 params and with
    bf16 params over fp32 masters; SGD also over ResNet-50's 161 tensors
    and LAMB over BERT-base's. The records: scale, l2norm and Adam at
    GPT-2 bf16 over masters ([train_amp]'s), LAMB at BERT-base fp32
    ([bert_train]'s), SGD at ResNet-50 fp32 over masters
    ([rn50_train]'s)."""
    from apex_tpu_torch.ops import multi_tensor as mt
    g = torch.Generator(device="cuda").manual_seed(17)
    gpt2 = _param_shapes("gpt2") + [(1,), (mt.CHUNK + 1,)]
    records = {}
    for dtype, master in ((torch.float32, False), (torch.bfloat16, True)):
        label = "gpt2-124m+2"
        recs = list(_mt_scale_and_norm(timer, mt, gpt2, dtype, g, label))
        for kind in ("adam", "lamb", "sgd"):
            recs.append(_mt_optimizer(timer, mt, kind, gpt2, dtype, master,
                                      g, label))
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            records.update({r["name"]: r for r in recs[:3]})
    records["multi_tensor_lamb"] = _mt_optimizer(
        timer, mt, "lamb", _param_shapes("bert"), torch.float32, False, g,
        "bert-base")
    records["multi_tensor_sgd"] = _mt_optimizer(
        timer, mt, "sgd", _param_shapes("rn50"), torch.float32, True, g,
        "resnet50")
    torch.cuda.empty_cache()
    return [records[k] for k in MT_REPLACES]


def optimizer_launches_per_step(opt) -> dict:
    """The multi-tensor launches one step of ``opt`` makes: a list per
    param group (the phases set no decay mask and one dtype), LAMB's
    global grad norm over every grad."""
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    out, every = {}, []
    for group in opt.param_groups:
        sizes = [p.numel() for p in group["params"]]
        every += sizes
        if isinstance(opt, FusedLAMB):
            got = mt.optimizer_launches(
                sizes, "multi_tensor_lamb",
                adapt=group["weight_decay"] != 0.0 or opt.always_adapt)
        elif isinstance(opt, FusedAdam):
            got = mt.optimizer_launches(sizes, "multi_tensor_adam")
        elif isinstance(opt, FusedSGD):
            got = mt.optimizer_launches(sizes, "multi_tensor_sgd")
        else:
            got = {}
        for k, v in got.items():
            out[k] = out.get(k, 0) + v
    if isinstance(opt, FusedLAMB) and opt.max_grad_norm > 0.0:
        out["multi_tensor_l2norm"] = out.get("multi_tensor_l2norm", 0) + \
            mt.optimizer_launches(every, "multi_tensor_l2norm")[
                "multi_tensor_l2norm"]
    return out


def report_optimizer(phase: str, opt, found_inf=None) -> None:
    """One optimizer step (the grads of the phase's last step) through the
    kernels: its launches (the wrappers' counters), device operations and
    device ms (torch.profiler) and CUDA-event ms; and through the
    per-parameter torch ops the parent ran (profiler). Each takes one more
    step."""
    from apex_tpu_torch.ops import LAUNCHES
    before = dict(LAUNCHES)
    ops, ms, names = device_work(lambda: opt.step(found_inf=found_inf))
    launches = {k: v - before[k] for k, v in LAUNCHES.items()
                if v != before[k]}
    todo = [(gi, group, p) for gi, group in enumerate(opt.param_groups)
            for p in group["params"] if p.grad is not None]
    pp_ops, pp_ms, _ = device_work(
        lambda: opt._step_per_parameter(todo, None, found_inf))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    opt.step(found_inf=found_inf)
    end.record()
    torch.cuda.synchronize()
    fmt = lambda x: x if isinstance(x, str) else f"{x:.3f}"  # noqa: E731
    kernels = {}
    for name, (count, _) in names.items():
        short = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0].split("<")[0].split("::")[-1]
        kernels[short] = kernels.get(short, 0) + count
    log("optimizer", path=phase, optimizer=type(opt).__name__,
        tensors=len(todo), launches=json.dumps(launches).replace(" ", ""),
        device_ops=ops, device_ms=fmt(ms),
        device_kernels=json.dumps(kernels).replace(" ", ""),
        event_ms=f"{start.elapsed_time(end):.3f}",
        per_parameter_device_ops=pp_ops, per_parameter_device_ms=fmt(pp_ms))


def _cpu_snapshot(tensors) -> list:
    """Host copies of device tensors (a bitwise record that costs no
    device memory, so the phase's peak is the step's own)."""
    return [t.detach().to("cpu", copy=True) for t in tensors]


def _zero_unused_grads(params) -> None:
    """Zero gradients for the parameters the loss does not reach (BERT's
    binary head under the LM loss), as ``make_train_step`` fills them and
    ``jax.grad`` gives them, so that LAMB's decoupled decay moves them."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _train_amp(phase: str, half, profile: bool, kind: str = "gpt2") -> dict:
    """One model at its train phase's shape under amp O2 with ``half``
    compute: ``kind`` "gpt2" (GPT-2 124M at [train]'s shape, FusedAdam lr
    1e-4), "bert" (BERT-base at [bert_train]'s: its seeded padding masks
    and tokentype ids; FusedLAMB lr 1e-3, weight decay 0.01), "t5" (the
    encoder-decoder at T5-base widths at [t5_train]'s shape with its
    seeded enc_lengths; FusedAdam lr 1e-4), each with ``half`` params
    (``policy.cast_to_param``), or "rn50" (ResNet-50 at [rn50_train]'s
    shape with ``compute_dtype=half`` over fp32 params, as the JAX
    package's ``examples/imagenet_amp.py`` runs it: batch norm and fc stay
    fp32; FusedSGD lr 0.1, momentum 0.9, wd 1e-4). The optimizer keeps
    fp32 masters, and a dynamic loss scaler (2**16, hysteresis 1) runs
    each step: scale_loss -> backward -> unscale (multi_tensor_scale) ->
    step(found_inf) -> update. Step AMP_INJECT_STEP gets an inf in one
    grad element after its backward: that step must leave every param,
    master, moment and step count bitwise unchanged, halve the scale and
    reset the growth tracker. bf16 must find no other inf. fp16 may
    overflow on its own (that is what the dynamic scale is for): each such
    step is reported and must leave the state bitwise unchanged and halve
    the scale too, and at least one step must apply. Returns the
    launches."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (BertModel, EncoderDecoderModel,
                                       GPTModel, TransformerConfig)
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.utils.flops import resnet50_train_flops
    state = amp.initialize("O2", half_dtype=half)
    gen = torch.Generator().manual_seed(0)
    unit, positions = "tokens", None
    if kind == "rn50":
        model, step_fn = _rn50_model(
            dict(depth=50, num_classes=1000, compute_dtype=half,
                 fused_conv=True), "cuda", master_weights=True)
        opt = step_fn.optimizer
        batch = _rn50_batch(RN50_BATCH, RN50_SIZE, 1000, "cuda", seed=14)
        kernels, unit, tokens = RN50_KERNELS, "images", RN50_BATCH
        flops = resnet50_train_flops(RN50_BATCH, RN50_SIZE)
        extra = dict(batch=RN50_BATCH, image=RN50_SIZE)
        forward = lambda: F.cross_entropy(model(batch[0]), batch[1])  # noqa
        name = f"resnet50 {str(half)[6:]} compute fp32 params"
    else:
        shape = {"bert": BERT, "t5": T5}.get(kind, GPT2)
        cfg = TransformerConfig(
            **shape, hidden_dropout=0.0, attention_dropout=0.0,
            compute_dtype=state.policy.compute_dtype,
            **(dict(attn_mask_type=AttnMaskType.padding)
               if kind == "bert" else {}))
        if kind == "bert":
            model = BertModel(cfg, device="cuda", generator=gen)
            kernels = BERT_KERNELS
            batch = _bert_batch(cfg, BERT_BATCH, BERT_SEQ, "cuda", seed=12)
            positions = BERT_BATCH * BERT_SEQ
            tokens = int(batch[1].sum())
            extra = dict(batch=BERT_BATCH, seq=BERT_SEQ, valid_tokens=tokens)
            forward = lambda: model(*batch)[0]  # noqa: E731
            name = "bert-base"
        elif kind == "t5":
            model = EncoderDecoderModel(cfg, device="cuda", generator=gen)
            kernels = T5_KERNELS
            batch = _t5_batch(cfg, T5_BATCH, T5_ENC, T5_DEC, "cuda",
                              seed=13)
            positions = T5_BATCH * (T5_ENC + T5_DEC)
            tokens = int(batch[3].sum()) + T5_BATCH * T5_DEC
            extra = dict(batch=T5_BATCH, enc_seq=T5_ENC, dec_seq=T5_DEC,
                         valid_tokens=tokens,
                         enc_lengths=json.dumps(batch[3].tolist()).replace(
                             " ", ""))
            forward = lambda: model(batch[0], batch[1], batch[2],  # noqa
                                    enc_lengths=batch[3])
            name = "t5-base-widths enc-dec"
        else:
            model = GPTModel(cfg, device="cuda", generator=gen)
            kernels = TRAIN_KERNELS
            batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
            tokens = TRAIN_BATCH * TRAIN_SEQ
            extra = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
            forward = lambda: model(*batch)  # noqa: E731
            name = "gpt2-124m"
        state.policy.cast_to_param(model)
        if any(p.dtype != half for p in model.parameters()):
            raise AssertionError(f"{phase}: params not all {half}")
        n_params = sum(p.numel() for p in model.parameters())
        if kind == "t5":
            flops = enc_dec_train_flops(model, T5_BATCH, T5_ENC, T5_DEC)
        else:
            seq = BERT_SEQ if kind == "bert" else TRAIN_SEQ
            flops = transformer_train_flops(
                n_params, positions or tokens, shape["num_layers"],
                shape["hidden_size"], seq, causal=kind != "bert")
        opt = (FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01,
                         master_weights=True) if kind == "bert" else
               FusedAdam(model.parameters(), lr=1e-4, master_weights=True))
        name += f" amp O2 {str(half)[6:]} params"
    params = list(model.parameters())
    scaler, ss = state.scaler, [state.scaler_states[0]]
    fp16 = half == torch.float16

    def step(inject):
        opt.zero_grad(set_to_none=True)
        loss = forward()
        amp.scale_loss(loss, ss[0]).backward()
        _zero_unused_grads(params)
        if inject:
            params[0].grad.view(-1)[0] = float("inf")
        _, found = scaler.unscale([p.grad for p in params], ss[0])
        opt.step(found_inf=found)
        ss[0] = scaler.update(ss[0], found)
        return loss.detach(), found

    def snapshot():
        out = list(params)
        for p in params:
            out += [v for v in opt.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, founds, scales, unchanged = [], [], [], [], {}
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        # fp16 may skip any step: keep a host copy before each one
        before = (_cpu_snapshot(snapshot())
                  if fp16 or i == AMP_INJECT_STEP else None)
        t0 = time.perf_counter()
        loss, found = step(i == AMP_INJECT_STEP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        founds.append(found)
        scales.append((ss[0].loss_scale.clone(),
                       ss[0].growth_tracker.clone()))
        if before is not None and bool(found):
            unchanged[i] = _all_equal(before, _cpu_snapshot(snapshot()))
        del before
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    founds = [bool(f) for f in founds]
    scale_walk = [(float(a), int(b)) for a, b in scales]
    sizes = [p.numel() for p in params]
    per_step = dict(kernels, **mt.optimizer_launches(
        sizes, "multi_tensor_scale"), **optimizer_launches_per_step(opt))
    natural = [i for i, f in enumerate(founds) if f and i != AMP_INJECT_STEP]
    applied = [i for i, f in enumerate(founds) if not f]
    fl = [float(x) for x in losses]
    _report_train(phase, f"{name} fp32 master random-init", fl, times,
                  launches, peak, per_step, tokens, flops, positions,
                  unit=unit, **extra, n_params=sum(sizes),
                  injected_step=AMP_INJECT_STEP,
                  found_inf=json.dumps(founds).replace(" ", ""),
                  natural_overflow_steps=json.dumps(natural).replace(" ", ""),
                  loss_scale=json.dumps([a for a, _ in scale_walk]).replace(
                      " ", ""),
                  skipped_steps_unchanged=json.dumps(
                      [unchanged[i] for i in sorted(unchanged)]).replace(
                          " ", ""),
                  injected_step_unchanged=unchanged.get(AMP_INJECT_STEP))
    before_scale = (scale_walk[AMP_INJECT_STEP - 1][0] if AMP_INJECT_STEP
                    else 2.0 ** 16)
    halved = all(scale_walk[i] == ((scale_walk[i - 1][0] if i else 2.0 ** 16)
                                   / 2, 0)
                 for i in [AMP_INJECT_STEP] + natural)
    ok = (founds[AMP_INJECT_STEP] and halved
          and all(unchanged.get(i) for i in [AMP_INJECT_STEP] + natural))
    if not fp16:
        ok = ok and not natural and before_scale == 2.0 ** 16
    elif not applied or not fl[applied[-1]] < fl[applied[0]]:
        ok = False
    if not ok:
        raise AssertionError(
            f"{phase}: found_inf {founds} (injected at {AMP_INJECT_STEP}), "
            f"skipped steps unchanged {unchanged}, scale walk {scale_walk}, "
            f"applied steps {applied} with losses {fl}")
    _, found = step(False)
    report_optimizer(phase, opt, found)
    if profile:
        profile_device(phase, lambda: [step(False) for _ in range(2)],
                       lambda: dict(steps=2, **extra))
    return launches


def phase_train_amp(profile: bool = False) -> dict:
    """``[train_amp]``: GPT-2 124M under amp O2 in bf16 (``_train_amp``):
    the injected inf is the only one."""
    return _train_amp("train_amp", torch.bfloat16, profile)


def phase_train_fp16(profile: bool = False) -> dict:
    """``[train_fp16]``: the same flow with ``half_dtype=torch.float16``
    (JAX's ``TestFp16Path`` at GPT-2 width): fp16 params and compute on
    Kernels A, D, E and F in fp16 (LN 25/25, packed 12/12 a step),
    unscale and Adam as the lists imply; natural overflows are allowed,
    each skipped bitwise and reported by step."""
    return _train_amp("train_fp16", torch.float16, profile)


def phase_bert_train_fp16(profile: bool = False) -> dict:
    """``[bert_train_fp16]``: BERT-base at ``[bert_train]``'s shape (b 16,
    s 512, seeded padding masks and tokentype ids) under
    ``amp.initialize("O2", half_dtype=torch.float16)``, FusedLAMB(lr 1e-3,
    weight decay 0.01) over fp32 masters, a dynamic scale from 2^16
    (``_train_amp``): Kernels A, D, G and H in fp16 (LN 26/26, softmax
    12/12 a step, the flash kernels 0), unscale, LAMB and its norms as the
    lists imply; the injected inf and every natural one skipped bitwise,
    the scale halved each time, at least one step applied and the loss
    falling."""
    return _train_amp("bert_train_fp16", torch.float16, profile, "bert")


def phase_t5_train_fp16(profile: bool = False) -> dict:
    """``[t5_train_fp16]``: the encoder-decoder at ``[t5_train]``'s shape
    (T5-base widths, 12 + 12 layers, b 16, encoder 512 with seeded
    enc_lengths, decoder 114) under ``amp.initialize("O2",
    half_dtype=torch.float16)``: fp16 params and compute, FusedAdam over
    fp32 masters, a dynamic scale from 2^16 (``_train_amp``). Kernels A, D,
    E, F, B and I in fp16 (LN 62/62, packed 24/24, 4D flash 12/12 a step),
    unscale and Adam as the lists imply; the injected inf and every
    natural one skipped bitwise, the scale halved each time, the loss
    falling."""
    return _train_amp("t5_train_fp16", torch.float16, profile, "t5")


def phase_rn50_train_fp16(profile: bool = False) -> dict:
    """``[rn50_train_fp16]``: ResNet-50 at ``[rn50_train]``'s shape (224
    px, b 256, fused_conv, FusedSGD over fp32 masters) with
    ``compute_dtype=torch.float16`` under amp O2's dynamic scale
    (``_train_amp``): Kernels J and K 36 times a step and L and M 13 times
    in fp16, SGD and unscale as the lists imply; cuDNN's stem and stride-2
    convs in fp16; the injected inf and every natural one skipped
    bitwise."""
    return _train_amp("rn50_train_fp16", torch.float16, profile, "rn50")


def phase_amp_card_vs_cpu() -> None:
    """A small f32 GPT runs the amp flow (``initialize("O2",
    half_dtype=float32)``: fp32 masters and a dynamic scale) 5 steps on the
    card and on the CPU from one seed, with an inf injected after the
    backward of step 2, once each with FusedAdam, FusedLAMB and FusedSGD:
    the losses to 1e-5 relative and the unscaled step-1 gradients to atol
    1e-5 + rtol 1e-4 (``phase_train_card_vs_cpu``'s f32 tolerances), the
    scaler states equal; the parameters after five steps to atol 1e-5 +
    rtol 1e-4 under SGD, and to atol 1e-4 under Adam and LAMB, which
    normalise each element's step: a gradient whose two sides differ in
    their last bits moves a weight by up to lr, as
    ``tests/test_torch_gpt_training.py`` holds Adam steps against JAX."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    cfg = TransformerConfig(**SMALL)
    makers = {"adam": lambda ps: FusedAdam(ps, lr=1e-3, master_weights=True),
              "lamb": lambda ps: FusedLAMB(ps, lr=1e-3, weight_decay=0.01,
                                           master_weights=True),
              "sgd": lambda ps: FusedSGD(ps, lr=0.1, momentum=0.9,
                                         weight_decay=1e-4,
                                         master_weights=True)}
    for name, make in makers.items():
        out = {}
        for device in ("cuda", "cpu"):
            state = amp.initialize("O2", half_dtype=torch.float32,
                                   device=device)
            model = GPTModel(cfg, device=device,
                             generator=torch.Generator().manual_seed(2))
            state.policy.cast_to_param(model)
            params = list(model.parameters())
            opt = make(params)
            sc, ss = state.scaler, state.scaler_states[0]
            batch = _train_batch(cfg, 4, 96, device, seed=3)
            losses, walk, grads = [], [], None
            for i in range(5):
                opt.zero_grad(set_to_none=True)
                loss = model(*batch)
                amp.scale_loss(loss, ss).backward()
                if i == 2:
                    params[0].grad.view(-1)[0] = float("inf")
                _, found = sc.unscale([p.grad for p in params], ss)
                if i == 0:
                    grads = _grad_tree(model)
                opt.step(found_inf=found)
                ss = sc.update(ss, found)
                losses.append(float(loss.detach()))
                walk.append(sc.state_dict(ss))
            out[device] = (losses, walk, grads, {
                n: p.detach().cpu().clone()
                for n, p in model.named_parameters()})
        (lc, wc, gc, pc), (lh, wh, gh, ph) = out["cuda"], out["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        grad_excess = max(float(((gc[n] - want).abs() - 1e-4 * want.abs()
                                 ).max()) for n, want in gh.items())
        atol, rtol = (1e-5, 1e-4) if name == "sgd" else (1e-4, 0.0)
        worst, worst_name = 0.0, None
        for n, want in ph.items():
            excess = float(((pc[n] - want).abs() - rtol * want.abs()).max())
            if worst_name is None or excess > worst:
                worst, worst_name = excess, n
        log("amp_card_vs_cpu", optimizer=name, steps=5, injected_step=2,
            losses_cuda=json.dumps(lc).replace(" ", ""),
            losses_cpu=json.dumps(lh).replace(" ", ""),
            loss_rel_err=f"{rel:.2e}", grad_excess=f"{grad_excess:.2e}",
            loss_scale=json.dumps([w["loss_scale"] for w in wc]).replace(
                " ", ""), scaler_equal=wc == wh,
            param_tol=f"atol_{atol:g}_rtol_{rtol:g}",
            worst_param_excess=f"{worst:.2e}", worst_leaf=worst_name)
        if rel > 1e-5 or grad_excess > 1e-5 or wc != wh or worst > atol or \
                wc[2]["loss_scale"] != wc[1]["loss_scale"] / 2:
            raise AssertionError(
                f"amp_card_vs_cpu {name}: loss rel err {rel} (1e-5), step-1 "
                f"grads {grad_excess} past atol 1e-5 + rtol 1e-4, scalers "
                f"{wc} vs {wh}, param {worst_name} off by {worst} past atol "
                f"{atol} + rtol {rtol}")
    _amp_fp16_card_vs_cpu("gpt2")
    _amp_fp16_card_vs_cpu("bert")
    _amp_fp16_card_vs_cpu("t5")


#: losses of the fp16 amp flow, card against CPU (``_amp_fp16_card_vs_cpu``)
AMP_FP16_LOSS_RTOL = 2e-3


def _amp_fp16_card_vs_cpu(kind: str) -> None:
    """A small model under amp O2 in fp16 (``initialize("O2",
    half_dtype=float16)``: fp16 params and compute, fp32 masters, a dynamic
    scale from 2^16, an inf injected after the backward of step 2) runs 5
    steps on the card (its kernels in fp16, cuBLAS's fp16 GEMMs with fp32
    sums) and on the CPU (the kernels' plain versions): ``kind`` "gpt2",
    the small GPT with FusedAdam lr 1e-3 (Kernels A, D, E and F), "bert",
    a small BERT with a seeded padding mask and FusedLAMB lr 1e-3, weight
    decay 0.01 (Kernels A, D, G and H), or "t5", a small encoder-decoder
    (RMSNorm, ReLU) with seeded enc_lengths and FusedAdam lr 1e-3 (Kernels
    A, D, E, F, B and I). Every parameter stays fp16,
    the scaler states agree at every step, and the losses within rtol
    ``AMP_FP16_LOSS_RTOL``. Both sides compute each op in fp32 and round
    it once to fp16, but sum in other orders, so a value near a rounding
    boundary lands on a neighbouring fp16 value (a 2^-11 relative step);
    the loss, a mean over such values through two layers, is held to four
    such steps (2e-3). cuBLAS's reduced-precision fp16 reductions are off
    for the comparison (they round partial sums to fp16, which the CPU
    never does)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (BertModel, EncoderDecoderModel,
                                       GPTModel, TransformerConfig)
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.transformer.enums import AttnMaskType
    bert = kind == "bert"
    extra = {"bert": dict(attn_mask_type=AttnMaskType.padding),
             "t5": dict(normalization="rmsnorm", activation="relu")}
    cfg = TransformerConfig(**SMALL, compute_dtype=torch.float16,
                            **extra.get(kind, {}))
    make = {"bert": BertModel, "t5": EncoderDecoderModel}.get(kind, GPTModel)
    keep = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    out = {}
    try:
        for device in ("cuda", "cpu"):
            state = amp.initialize("O2", half_dtype=torch.float16,
                                   device=device)
            gen = torch.Generator().manual_seed(2)
            model = make(cfg, device=device, generator=gen)
            state.policy.cast_to_param(model)
            params = list(model.parameters())
            opt = (FusedLAMB(params, lr=1e-3, weight_decay=0.01,
                             master_weights=True) if bert else
                   FusedAdam(params, lr=1e-3, master_weights=True))
            sc, ss = state.scaler, state.scaler_states[0]
            if kind == "t5":
                batch = _t5_batch(cfg, 4, 96, 40, device, seed=7)
            elif bert:
                batch = _bert_batch(cfg, 4, 96, device, seed=5)
            else:
                batch = _train_batch(cfg, 4, 96, device, seed=3)
            losses, walk = [], []
            for i in range(5):
                opt.zero_grad(set_to_none=True)
                if kind == "t5":
                    loss = model(*batch[:3], enc_lengths=batch[3])
                else:
                    loss = model(*batch)
                if bert:
                    loss = loss[0]
                amp.scale_loss(loss, ss).backward()
                _zero_unused_grads(params)
                if i == 2:
                    params[0].grad.view(-1)[0] = float("inf")
                _, found = sc.unscale([p.grad for p in params], ss)
                opt.step(found_inf=found)
                ss = sc.update(ss, found)
                losses.append(float(loss.detach()))
                walk.append(sc.state_dict(ss))
            out[device] = (losses, walk,
                           all(p.dtype == torch.float16 for p in params))
    finally:
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            keep
    (lc, wc, hc), (lh, wh, hh) = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    log("amp_card_vs_cpu", model=kind, optimizer="lamb" if bert else "adam",
        half="float16", steps=5,
        injected_step=2, losses_cuda=json.dumps(lc).replace(" ", ""),
        losses_cpu=json.dumps(lh).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", loss_rtol=AMP_FP16_LOSS_RTOL,
        loss_scale=json.dumps([w["loss_scale"] for w in wc]).replace(
            " ", ""), scaler_equal=wc == wh, params_fp16=hc and hh)
    if rel > AMP_FP16_LOSS_RTOL or wc != wh or not (hc and hh) or \
            wc[2]["loss_scale"] != wc[1]["loss_scale"] / 2 or \
            not lc[-1] < lc[0]:
        raise AssertionError(
            f"amp_card_vs_cpu fp16 {kind}: loss rel err {rel} "
            f"({AMP_FP16_LOSS_RTOL}), scalers {wc} vs {wh}, params fp16 "
            f"{hc} {hh}, losses {lc}")


#: Kernel A's and D's wide-row checks: every width in each dtype, LayerNorm
#: and RMSNorm, at a decode step's 8 rows and 2048 rows. 16384 is
#: Llama-3.1-405B's hidden size, 18432 a wider multiple of 128, 32768 past
#: D's element limit (29056), 16388 a width off 8 (no 16-byte rows)
LN_WIDE_H = (16384, 18432, 32768, 16388)
LN_WIDE_ROWS = (8, 2048)
#: the timed cases (rows, h, RMSNorm), bf16 x and y: the 405B decode step's
#: RMSNorm over bf16 w (the kernels line's record), then training rows over
#: fp32 w and b
LN_WIDE_TIMED = [(8, 16384, True), (2048, 16384, False), (2048, 16384, True),
                 (2048, 32768, False)]


def _ln_wide_case(x, dy, w, b, is_rms) -> dict:
    """Kernels A and D on one wide case against their plain versions on the
    card (``[layer_norm]``'s bars: y and dx ``check_close``, the fp32
    statistics 1e-4, dw and db 1e-4 of 1 + |value|), two runs bitwise
    equal; the paths taken."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_cuda_plan,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_cuda,
                                               layer_norm_fwd_cuda_plan,
                                               layer_norm_fwd_plain)
    dtype = x.dtype
    y, mean, iv = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, dtype)
    again = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, dtype)
    ry, rmean, riv = layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                          torch.float32)
    dx, dw, db = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms,
                                     b is not None)
    again_b = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms, b is not None)
    rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean, iv, w,
                                         is_rms, b is not None)
    torch.cuda.synchronize()
    y_ulps, y_ok, tol = check_close(y, ry.to(dtype))
    dx_ulps, dx_ok, _ = check_close(dx, rdx.to(dtype))
    stat_err = max(float((mean - rmean).abs().max()),
                   float((iv - riv).abs().max()))
    dw_err = max(float(((dw - rdw).abs() / (1.0 + rdw.abs())).max()),
                 0.0 if db is None else
                 float(((db - rdb).abs() / (1.0 + rdb.abs())).max()))
    same = all(torch.equal(u, v) for u, v in zip((y, mean, iv), again)) and \
        all((u is None and v is None) or torch.equal(u, v)
            for u, v in zip((dx, dw, db), again_b))
    return dict(
        fwd_path=layer_norm_fwd_cuda_plan(x, y, w, b).path,
        bwd_path=layer_norm_bwd_cuda_plan(dy, x, dx, w, b is not None).path,
        y_err=float((y.float() - ry).abs().max()), y_ulps=y_ulps,
        dx_err=float((dx.float() - rdx).abs().max()), dx_ulps=dx_ulps,
        stat_err=stat_err, dw_db_rel_err=dw_err, repeat_bitwise=same,
        ok=y_ok and dx_ok and stat_err <= 1e-4 and dw_err <= 1e-4 and same,
        tol=tol.replace(" ", "_"), y_sha256=digest(y), dx_sha256=digest(dx))


def _ln_wide_timed(timer: Timer, rows, h, is_rms, g) -> tuple:
    """A and D at one timed shape (bf16 x, y and dy): ms warm and cold
    beside the plain versions, the library calls and the byte bounds."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_cuda,
                                               layer_norm_fwd_plain)
    dtype = torch.bfloat16
    wdt = dtype if rows == 8 else torch.float32
    x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
         + 0.5).to(dtype)
    dy = torch.randn(rows, h, device="cuda", generator=g).to(dtype)
    w = (1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)).to(wdt)
    b = None if is_rms else (0.1 * torch.randn(
        h, device="cuda", generator=g)).to(wdt)
    fwd = lambda: layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, dtype)  # noqa
    y, mean, iv = fwd()
    bwd = lambda: layer_norm_bwd_cuda(dy, x, mean, iv, w,  # noqa: E731
                                      is_rms, b is not None)
    ry = layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                              torch.float32)[0]
    err = float((y.float() - ry.to(dtype).float()).abs().max())
    esz, wsz = x.element_size(), w.element_size()
    n_w = 1 if is_rms else 2
    f_bms, f_by = bound_ms(2 * rows * h * esz + n_w * h * wsz + 2 * rows * 4,
                           8.0 * rows * h, dtype)
    b_bms, b_by = bound_ms(3 * rows * h * esz + 2 * rows * 4 + h * wsz
                           + n_w * h * 4, 12.0 * rows * h, dtype)
    wl, bl = w.to(dtype), None if b is None else b.to(dtype)
    out = {}
    for kernel, run, plain, bms, by in (
            ("A", fwd, lambda: layer_norm_fwd_plain(x, w, b, 1e-5, is_rms,
                                                    dtype), f_bms, f_by),
            ("D", bwd, lambda: layer_norm_bwd_plain(dy, x, mean, iv, w,
                                                    is_rms, b is not None),
             b_bms, b_by)):
        lib = None
        if kernel == "A":
            if not is_rms:
                lib = timer(lambda: F.layer_norm(x, (h,), wl, bl, 1e-5))
            elif hasattr(F, "rms_norm"):
                lib = timer(lambda: F.rms_norm(x, (h,), wl, 1e-5))
        elif not is_rms:
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wl, bl,
                                                               1e-5)
            lib = timer(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], lmean, lrstd, wl, bl, [True, True, True]))
        out[kernel] = dict(ms=timer(run), ms_cold=timer(run, cold=True),
                           plain_ms=timer(plain), library_ms=lib,
                           bound_ms=bms, bound_by=by)
        log("layer_norm_wide_timed", kernel=kernel, shape=f"[{rows},{h}]",
            dtype="bfloat16", w=str(wdt)[6:], rms=is_rms,
            ms=f"{out[kernel]['ms']:.5f}",
            ms_cold=f"{out[kernel]['ms_cold']:.5f}",
            plain_ms=f"{out[kernel]['plain_ms']:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by)
    return out, err


def phase_layer_norm_wide(timer: Timer) -> dict:
    """Kernels A and D past their element kernels' shared memory (A's wide
    path past h 14336, D's past 29056): every case of ``LN_WIDE_H`` x
    ``LN_WIDE_ROWS`` in f32, bf16 and fp16 (fp32 w and b beside f32 and
    bf16 x, fp16 beside fp16 x, as amp O2 runs them), LayerNorm and
    RMSNorm, against the plain versions; then ``LN_WIDE_TIMED``. Returns
    the record of A's wide path at the 405B decode step's rows."""
    g = torch.Generator(device="cuda").manual_seed(22)
    for h in LN_WIDE_H:
        w32 = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
        b32 = 0.1 * torch.randn(h, device="cuda", generator=g)
        for rows in LN_WIDE_ROWS:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
                     + 0.5).to(dtype)
                dy = torch.randn(rows, h, device="cuda", generator=g).to(
                    dtype)
                wdt = torch.float16 if dtype == torch.float16 else \
                    torch.float32
                for is_rms in (False, True):
                    got = _ln_wide_case(x, dy, w32.to(wdt), None if is_rms
                                        else b32.to(wdt), is_rms)
                    want_bwd = "wide" if h > 29056 else "element"
                    ok = got.pop("ok") and got["fwd_path"] == "wide" and \
                        got["bwd_path"] == want_bwd
                    log("layer_norm_wide", shape=f"[{rows},{h}]",
                        dtype=str(dtype)[6:], w=str(wdt)[6:], rms=is_rms,
                        **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                           for k, v in got.items()})
                    if not ok:
                        raise AssertionError(
                            f"layer_norm_wide [{rows},{h}] {dtype} "
                            f"rms={is_rms}: {got} (bwd path expected "
                            f"{want_bwd})")
    record = None
    for rows, h, is_rms in LN_WIDE_TIMED:
        out, err = _ln_wide_timed(timer, rows, h, is_rms, g)
        if record is None:
            record = dict(name="layer_norm_fwd_wide", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_fwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:50",
                          shape=f"x[{rows},{h}] bf16 rms, w bf16 (wide path)",
                          max_abs_err=err, **{k: out["A"][k] for k in (
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")})
    return record


#: Llama-3.1-405B's widths (meta-llama/Llama-3.1-405B config.json: hidden
#: 16384, 128 query heads of 128 over 8 K/V heads, SwiGLU 53248, RMSNorm
#: eps 1e-5, RoPE theta 500000, vocab 128256) on the repo's GPT blocks
#: (their biases, a tied head, no llama3 RoPE scaling), depth cut from 126
#: layers to 2: A at h 16384 (the wide path), B at GQA 16:1, C with a
#: group of 16 query rows cut into two chunks of 8
LLAMA405B = dict(num_layers=2, hidden_size=16384, num_attention_heads=128,
                 num_query_groups=8, ffn_hidden_size=53248,
                 activation="swiglu", normalization="rmsnorm",
                 layernorm_epsilon=1e-5, position_embedding_type="rope",
                 rope_theta=500000.0, vocab_size=128256,
                 max_position_embeddings=131072, hidden_dropout=0.0,
                 attention_dropout=0.0)


def phase_llama405b_serve(profile: bool = False) -> dict:
    """The 2-layer cut of Llama-3.1-405B's widths (:data:`LLAMA405B`, bf16
    params and compute, weights drawn on the card from a seed) serves 8
    greedy requests of ``PROMPT_LENS`` prompts and 32 new tokens through
    ``[serve]``'s engine: every request ends ``length``/``eos``, A
    launches 5 a forward (2 RMSNorms a layer + the final one, all on the
    wide path), B 2 a prefill, C 2 a decode step with two head chunks,
    every other kernel 0. Returns the launches."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.ops.decode_attention import _card_plan
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = TransformerConfig(**LLAMA405B, params_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = GPTModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the init's peak holds a layer's fp32 draw beside the bf16 weights
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64,
                        prefix_cache=False)
    plan = _card_plan(8, cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim,
                      64, 768 // 64, torch.bfloat16, True, None, 0)
    groups = cfg.num_attention_heads // cfg.kv_heads
    if plan.heads * 2 != groups:
        raise AssertionError(f"llama405b_serve: C's plan {plan} does not "
                             f"cut the group of {groups} into two chunks")
    InferenceEngine(model, ecfg).serve(_requests(2, cfg.vocab_size, 4, 9))
    engine = InferenceEngine(model, ecfg)
    requests = _requests(8, cfg.vocab_size, 32, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != 8 or bad:
        raise AssertionError(f"llama405b_serve: {len(results)} results, bad "
                             f"finish reasons {bad}")
    counters = engine.metrics.counters()
    steps, prefills = counters["decode_steps"], counters["prefills"]
    layers = cfg.num_layers
    want = {k: 0 for k in ALL_KERNELS}
    want.update(flash_fwd=layers * prefills, paged_decode=layers * steps,
                layer_norm_fwd=(2 * layers + 1) * (prefills + steps))
    if launches != want:
        raise AssertionError(f"llama405b_serve: launches {launches}, "
                             f"expected {want}")
    n_tok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results)
    step_h = engine.metrics.histogram("decode_step_s")
    log("llama405b_serve", model="llama-3.1-405b-widths-2-layers bf16 "
        "random-init", n_params=n_params, requests=8, tokens=n_tok,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{n_tok / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}",
        decode_ms_per_step=f"{1e3 * step_h.sum / step_h.count:.3f}",
        decode_steps=steps, prefills=prefills,
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        init_peak_gb=f"{init_peak:.3f}", init_s=f"{init_s:.2f}",
        c_plan=_decode_plan_text(plan),
        card=_card_name().replace(" ", "_"),
        launches=json.dumps(launches).replace(" ", ""))
    if profile:
        profile_serve(model, ecfg)
    del engine, model
    torch.cuda.empty_cache()
    return launches


#: a tiny config that still takes A's wide path (hidden 16384; D runs its
#: element kernel below 29056): 128 query heads of 128 over 8 groups
WIDE_SMALL = dict(num_layers=1, hidden_size=16384, num_attention_heads=128,
                  num_query_groups=8, ffn_hidden_size=1024, vocab_size=512,
                  max_position_embeddings=128, hidden_dropout=0.0,
                  attention_dropout=0.0)


def phase_wide_card_vs_cpu() -> None:
    """:data:`WIDE_SMALL` in f32 (TF32 off), on the card and on the CPU
    from one seed: serves 3 greedy requests (the tokens are equal), then
    trains 3 steps (``_card_vs_cpu``'s bar)."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request
    cfg = TransformerConfig(**WIDE_SMALL)

    # lr 1e-6: at this width Adam's first steps at 1e-4 move 600 M weights
    # together far enough to drive the fixed batch's loss to 0
    def build(device):
        model, step = _train_model(cfg, device, seed=8, lr=1e-6)
        return model, step, _train_batch(cfg, 2, 16, device, seed=9)

    def serve(device, model):
        g = torch.Generator()
        reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                             generator=g.manual_seed(n))
                        .tolist(), max_new_tokens=6) for n in (9, 20, 33)]
        eng = InferenceEngine(model, EngineConfig(
            max_slots=4, max_len=64, page_size=16, prefix_cache=False),
            device=device)
        return [r.tokens for r in eng.serve(reqs)]

    # one model a device: it serves, then trains
    out = _card_vs_cpu("wide_card_vs_cpu", build, before=serve, layers=1,
                       hidden=16384)
    if out["cuda"] != out["cpu"] or any(len(t) != 6 for t in out["cuda"]):
        raise AssertionError(f"wide card vs CPU greedy tokens differ: {out}")
    log("wide_card_vs_cpu", serve="greedy", requests=3,
        tokens=json.dumps(out["cuda"]).replace(" ", ""), equal=True)
    torch.cuda.empty_cache()


#: GPT-2's published dropout (attn_pdrop, resid_pdrop, embd_pdrop 0.1) and
#: the variants ``[train_features]`` runs: (name, config knobs)
TRAIN_FEATURES = [("dropout", {}), ("dropout_full", dict(recompute="full")),
                  ("dropout_selective", dict(recompute="selective")),
                  ("dropout_chunks4", dict(loss_seq_chunks=4))]


def _dropout_train_model(cfg, device, seed=0, key_seed=0, bert=False):
    """A GPT (or BERT) whose steps train with dropout on: step ``i`` draws
    its masks from ``fold_in(prng_key(key_seed), i)``."""
    from apex_tpu_torch.models import BertModel, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.training import make_train_step
    from apex_tpu_torch.utils import prng
    gen = torch.Generator().manual_seed(seed)
    model = (BertModel if bert else GPTModel)(cfg, device=device,
                                              generator=gen)
    opt = (FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01) if bert
           else FusedAdam(model.parameters(), lr=1e-4))
    base = prng.prng_key(key_seed, device=device)
    count = [0]

    def loss_fn(batch):
        key = prng.fold_in(base, count[0])
        count[0] += 1
        out = model(*batch, rng=key, deterministic=False)
        return out[0] if bert else out

    step = make_train_step(loss_fn, opt)
    step.optimizer = opt
    return model, step


def phase_train_features(profile: bool = False) -> dict:
    """GPT-2 124M at ``[train]``'s shapes (b 8 x 1024, bf16 over fp32,
    FusedAdam) with GPT-2's dropout 0.1 takes 2 + 8 steps in each variant
    of :data:`TRAIN_FEATURES`: the loss falls and every kernel launches
    what a step implies (E and F with the dropout on; a recomputed layer
    launches its LayerNorms and E twice). Then the cost of the threefry
    masks as torch int64 ops: one ``bernoulli`` over ``[s, b, h]``.
    Returns the launches of each variant."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.utils import prng
    paths = {}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    layers = GPT2["num_layers"]
    for name, knobs in TRAIN_FEATURES:
        torch.cuda.empty_cache()
        cfg = TransformerConfig(**GPT2, hidden_dropout=0.1,
                                attention_dropout=0.1, **knobs,
                                params_dtype=torch.float32,
                                compute_dtype=torch.bfloat16)
        model, step = _dropout_train_model(cfg, "cuda")
        batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
        n_params = sum(p.numel() for p in model.parameters())
        losses, times, launches, peak = _timed_steps(step, batch)
        per_step = dict(TRAIN_KERNELS,
                        **optimizer_launches_per_step(step.optimizer))
        if knobs.get("recompute"):
            per_step["layer_norm_fwd"] += 2 * layers
            per_step["flash_packed_fwd"] += layers
        _report_train(f"train_features_{name}",
                      "gpt2-124m bf16/fp32 random-init dropout 0.1", losses,
                      times, launches, peak, per_step, tokens,
                      transformer_train_flops(n_params, tokens, layers,
                                              GPT2["hidden_size"], TRAIN_SEQ,
                                              causal=True),
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      **{k: v for k, v in knobs.items()})
        if profile and name == "dropout":
            profile_device("train_features_dropout",
                           lambda: [step(batch) for _ in range(2)],
                           lambda: dict(steps=2, batch=TRAIN_BATCH,
                                        seq=TRAIN_SEQ))
        paths[f"train_features_{name}"] = launches
        del model, step, batch
    key = prng.prng_key(3, device="cuda")
    shape = (TRAIN_SEQ, TRAIN_BATCH, GPT2["hidden_size"])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prng.bernoulli(key, 0.9, shape)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        prng.bernoulli(key, 0.9, shape)
    end.record()
    torch.cuda.synchronize()
    mask_ms = start.elapsed_time(end) / 10
    _, mask_ms_profiled, _ = device_work(lambda: prng.bernoulli(key, 0.9,
                                                                shape))
    # masks a step: embedding, then 2 a layer (after attention and MLP)
    log("train_features_masks", shape=f"[{TRAIN_SEQ},{TRAIN_BATCH},"
        f"{GPT2['hidden_size']}]", mask_ms=f"{mask_ms:.3f}",
        mask_device_ms=mask_ms_profiled if isinstance(mask_ms_profiled, str)
        else f"{mask_ms_profiled:.3f}", masks_a_step=2 * layers + 1,
        ms_a_step=f"{mask_ms * (2 * layers + 1):.2f}")
    torch.cuda.empty_cache()
    return paths


def phase_train_features_card_vs_cpu() -> None:
    """A small f32 GPT (Adam) and BERT (padding mask, LAMB) with dropout
    0.1 train 3 steps on the card and the CPU under no recompute, every
    recompute mode and ``loss_seq_chunks=2``: ``_card_vs_cpu``'s bar.
    Then the masks: ``bernoulli`` (hidden and softmax dropout) and the
    packed attention's ``randint`` seeds bitwise the CPU's; and on the
    card the step-1 gradients of each recompute mode bitwise those without
    recompute."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.models.transformer import _layer_seed
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.utils import prng
    drop = dict(SMALL, hidden_dropout=0.1, attention_dropout=0.1)
    modes = [("none", {}), ("true", dict(recompute=True)),
             ("full", dict(recompute="full")),
             ("selective", dict(recompute="selective")),
             ("chunks2", dict(loss_seq_chunks=2))]
    for kind in ("gpt", "bert"):
        grads = {}
        for name, knobs in modes:
            if kind == "bert" and name == "chunks2":
                continue        # BERT's head has no chunked loss
            cfg = TransformerConfig(
                **drop, **knobs, **({} if kind == "gpt" else dict(
                    attn_mask_type=AttnMaskType.padding)))

            def build(device):
                model, step = _dropout_train_model(
                    cfg, device, seed=2, key_seed=4, bert=kind == "bert")
                batch = (_train_batch(cfg, 4, 96, device, seed=3)
                         if kind == "gpt" else
                         _bert_batch(cfg, 4, 96, device, seed=5))
                return model, step, batch

            _card_vs_cpu("train_features_card_vs_cpu", build, model=kind,
                         mode=name, layers=2, hidden=128)
            for run in (name, f"{name}_again") if name == "none" else (name,):
                model, step, batch = build("cuda")
                step(batch)
                grads[run] = _grad_tree(model)
        # a leaf whose step-1 gradient two runs without recompute do not
        # repeat bitwise (an order of sums the card does not fix) cannot
        # hold recompute to bitwise; every other leaf must
        base = grads.pop("none")
        again = grads.pop("none_again")
        unrepeatable = [k for k, g in base.items() if not torch.equal(
            g, again[k])]
        differ = {name: [k for k, g in tree.items() if k not in unrepeatable
                         and not torch.equal(g, base[k])]
                  for name, tree in grads.items() if name != "chunks2"}
        log("train_features_recompute_bitwise", model=kind,
            leaves=len(base), unrepeatable=unrepeatable or None,
            **{f"{k}_leaves_differing": len(v) for k, v in differ.items()})
        if any(differ.values()):
            raise AssertionError(f"train_features_card_vs_cpu {kind}: "
                                 f"recompute grads differ from no "
                                 f"recompute on the card: {differ}")
    for seed in (0, 7, -3):
        keys = {d: prng.fold_in(prng.prng_key(seed, device=d), 5)
                for d in ("cuda", "cpu")}
        masks = {d: prng.bernoulli(k, 0.9, (96, 4, 128)) for d, k in
                 keys.items()}
        seeds = {d: [int(_layer_seed(prng.randint(k, (1,), -2 ** 31,
                                                  2 ** 31 - 1), i))
                     for i in range(3)] for d, k in keys.items()}
        if not torch.equal(masks["cuda"].cpu(), masks["cpu"]) or \
                seeds["cuda"] != seeds["cpu"]:
            raise AssertionError(f"train_features_card_vs_cpu: masks or "
                                 f"seeds differ at key seed {seed}")
    log("train_features_card_vs_cpu", masks="bernoulli_bitwise",
        attention_seeds="randint_bitwise", keys=3)


# ---------------------------------------------------------------------------
# Head dims up to 512: Kernels B, I, E, F and C at DMAX 512, a GPT with
# 512-wide heads
# ---------------------------------------------------------------------------

#: HD512: the repo's GPT blocks at meta-llama/Llama-2-7b config.json's
#: widths (hidden 4096, SwiGLU 11008, vocab 32000, RMSNorm eps 1e-5, RoPE
#: theta 10000) with 8 query heads of 512 over 2 K/V heads in place of its
#: 32 heads of 128 (no public model has heads past 256), 32 layers cut to 4;
#: unlike Llama, biases on the QKV, output and down projections and a tied
#: head. Launches a training step: 2 RMSNorms a layer + the final one, one
#: packed attention a layer (Kernels E and F at DMAX 512)
HD512 = dict(num_layers=4, hidden_size=4096, num_attention_heads=8,
             num_query_groups=2, ffn_hidden_size=11008, activation="swiglu",
             normalization="rmsnorm", layernorm_epsilon=1e-5,
             position_embedding_type="rope", rope_theta=10000.0,
             vocab_size=32000, max_position_embeddings=4096)
HD512_BATCH, HD512_SEQ = 2, 1024
HD512_KERNELS = {"layer_norm_fwd": 9, "layer_norm_bwd": 9,
                 "flash_packed_fwd": 4, "flash_packed_bwd": 4}
#: the tiny 512-wide-head GPT of tests/test_torch_hd512.py's widths (2
#: query heads of 512 over one K/V head, SwiGLU, RMSNorm, RoPE)
HD512_SMALL = dict(num_layers=2, hidden_size=1024, num_attention_heads=2,
                   num_query_groups=1, ffn_hidden_size=256,
                   activation="swiglu", normalization="rmsnorm",
                   position_embedding_type="rope", vocab_size=128,
                   max_position_embeddings=128, hidden_dropout=0.0,
                   attention_dropout=0.0)

#: Kernels E and F past 256: (name, b, s, groups, qpg, d, causal,
#: kv_lengths, window, rot, rate) — HD512's training shape (timed; GQA
#: 4:1, RoPE over 512), MQA 8:1 with a window and dropout, and widths off
#: 64 (384 with half the columns rotated and a 0 length, 320 under GQA 4:1
#: with dropout, 392 with a window) and off 8 (260: the element copies)
HD512_PACKED = [
    ("hd512_train", HD512_BATCH, HD512_SEQ, 2, 4, 512, True, None, None, 512,
     0.0),
    ("mqa_window_dropout", 1, 512, 1, 8, 512, True, None, 128, 512, 0.1),
    ("d384_rope_half_kv_lengths_0", 3, 256, 2, 2, 384, False, [256, 100, 0],
     None, 192, 0.0),
    ("d320_gqa4_dropout", 2, 256, 1, 4, 320, True, None, None, 0, 0.2),
    ("d392_window", 1, 300, 2, 1, 392, True, None, 64, 0, 0.0),
    ("d260_rope_half_kv_lengths", 2, 200, 1, 2, 260, True, [200, 77], None,
     130, 0.0),
]
#: Kernels B and I past 256: (name, b, h, kvh, sq, sk, d, causal,
#: kv_lengths, window) — HD512's heads over [b, h, s, d] (timed; GQA 4:1),
#: MQA 8:1 with a 0 length, and widths off 64 and 8 with a window, sq < sk
#: and sq > sk
HD512_FLASH = [
    ("hd512_4d", HD512_BATCH, 8, 2, HD512_SEQ, HD512_SEQ, 512, True, None,
     None),
    ("mqa_kv_lengths_0", 3, 8, 1, 256, 256, 512, False, [256, 90, 0], None),
    ("d384_window", 1, 4, 2, 300, 300, 384, True, None, 64),
    ("d320_sq_lt_sk", 2, 4, 4, 100, 333, 320, True, [333, 200], None),
    ("d392_gqa_sq_gt_sk", 1, 8, 2, 200, 150, 392, True, None, None),
    ("d260_gqa_kv_lengths", 2, 4, 2, 150, 150, 260, True, [150, 61], None),
]


def phase_flash_hd512(timer: Timer) -> tuple:
    """Kernels E, F, B and I past head_dim 256 (``[flash_hd512]`` lines):
    returns (records, the launches of ``flash_attention``'s autograd at
    HD512's 4D shape, the main path of ``flash_bwd_hd512``)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    recs = _wide_packed(timer, gen, "flash_hd512", HD512_PACKED,
                        "hd512_train")
    flash_recs, launches = _wide_flash(timer, gen, "flash_hd512",
                                       HD512_FLASH, "hd512_4d")
    torch.cuda.empty_cache()
    return recs + flash_recs, launches


#: Kernel C at head_dim 512 (HD512's decode: 8 query heads over 2 K/V
#: heads): (name, dtype, pool dtype, w, sliding window, page, path) — the
#: vector path in bf16, fp16 and f32, over int8 pools, a w = 4 window (16
#: query rows a kv head: four chunks of 4) with a sliding window, at pages
#: of 64; the element path (f32 q over int8 pools) in 32-row tiles at
#: pages of 64 and 128
DECODE_HD512_CASES = [
    ("gqa_dh512", torch.bfloat16, torch.bfloat16, 1, None, 64, "vector"),
    ("gqa_dh512", torch.float16, torch.float16, 1, None, 64, "vector"),
    ("gqa_dh512", torch.float32, torch.float32, 1, None, 64, "vector"),
    ("gqa_dh512_int8", torch.bfloat16, torch.int8, 1, None, 64, "vector"),
    ("gqa_dh512_int8", torch.float16, torch.int8, 1, None, 64, "vector"),
    ("gqa_dh512_w4_window", torch.bfloat16, torch.bfloat16, 4, 300, 64,
     "vector"),
    ("gqa_dh512_element_f32_int8", torch.float32, torch.int8, 1, None, 64,
     "element"),
    ("gqa_dh512_element_f32_int8_page128", torch.float32, torch.int8, 1,
     None, 128, "element"),
]


def phase_decode_hd512(timer: Timer) -> dict:
    """Kernel C past head_dim 256 (``[kernel_c] case=gqa_dh512``):
    :data:`DECODE_HD512_CASES` at b 8, 8 query heads over 2 K/V heads,
    positions 63-700, each against its plain version (``_decode_check``:
    1 ulp, f32 atol 1e-4, two runs bitwise equal) on the path named, with
    the element path's tile (``element_tile``: 32 rows); the element path
    at head_dim 260 (bf16 and fp16, pages of 64, whole pages); the element
    path's cases timed cold; then HD512's bf16
    decode timed cold beside its plain version and bound (the record
    ``paged_decode_hd512``)."""
    from apex_tpu_torch.ops.decode_attention import (
        decode_plain, element_tile, paged_decode_cuda, paged_decode_smem)
    g = torch.Generator(device="cuda").manual_seed(24)
    b, hl, group, dh, ps, pps = 8, 8, 4, 512, 64, 12
    positions = (63, 64, 200, 700) * 2
    for name, dtype, pool, w, window, page, path in DECODE_HD512_CASES:
        q, kp, vp, pt, pos, ks, vs = _decode_window_inputs(
            b, hl, group, dh, page, ps * pps // page, positions, dtype, g,
            w, pool == torch.int8)
        if w == 1:
            q = q[:, 0].contiguous()
        _, plan, _ = _decode_check(name, q, kp, vp, pt, pos, group, window,
                                   ks, vs)
        smem = paged_decode_smem(plan, dh, page, pool == torch.int8)
        tile = element_tile(w * group, dh, page) if path == "element" \
            else None
        if plan.path != path or (path == "vector" and plan.pieces !=
                                 (4 if dtype == torch.float32 else 2)) or \
                (path == "element" and tile != 32):
            raise AssertionError(f"paged_decode {name} {dtype}: plan {plan}"
                                 f", tile {tile}")
        ms = None
        if path == "element":
            ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, group,
                                                 window, ks, vs),
                       cold=True, iters=10)
        log("kernel_c", case=name, dtype=str(dtype)[6:],
            pool=str(pool)[6:], w=w, window=window, page=page,
            pieces=plan.pieces, smem_bytes=smem, element_tile=tile,
            plan=_decode_plan_text(plan),
            ms=None if ms is None else f"{ms:.5f}")
        del q, kp, vp, ks, vs
    for dtype in (torch.bfloat16, torch.float16):
        q, kp, vp, pt, pos = _decode_inputs(b, hl, group, 260, ps, pps,
                                            positions, dtype, g)
        _, plan, _ = _decode_check("element_dh260", q, kp, vp, pt, pos,
                                   group, None)
        if plan.path != "element" or element_tile(group, 260, ps) != ps:
            raise AssertionError(f"paged_decode element_dh260: plan {plan}")
        ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, group,
                                             None), cold=True, iters=10)
        log("kernel_c", case="element_dh260", dtype=str(dtype)[6:],
            smem_bytes=paged_decode_smem(plan, 260, ps),
            element_tile=ps, plan=_decode_plan_text(plan), ms=f"{ms:.5f}")
        del q, kp, vp
    dtype = torch.bfloat16
    q, kp, vp, pt, pos = _decode_inputs(b, hl, group, dh, ps, pps, positions,
                                        dtype, g)
    err, plan, _ = _decode_check("gqa_dh512_timed", q, kp, vp, pt, pos,
                                 group, None)
    rows = _decode_rows(positions, ps, pps, None)
    bms, by = bound_ms(_decode_bytes(q, pt, positions, ps, hl // group,
                                     None), 4.0 * dh * hl * rows, dtype)
    ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, group, None),
               cold=True)
    plain = timer(lambda: decode_plain(q, kp, vp, pt, pos, group, None),
                  cold=True, iters=10)
    log("kernel_c", case="gqa_dh512", shape=f"b{b} heads{hl} kvh2 dh{dh} "
        f"page{ps}", positions=list(positions[:4]), dtype="bfloat16",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
        library_ms=None, bound_ms=f"{bms:.5f}", bound_by=by, rows_read=rows,
        plan=_decode_plan_text(plan))
    torch.cuda.empty_cache()
    return dict(name="paged_decode_hd512", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/decode_attention.py:272",
                shape=f"b{b} heads{hl} kvh2 dh{dh} page{ps} bfloat16 cold L2",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_hd512(profile: bool = False) -> dict:
    """A GPT at :data:`HD512` trains at b 2, s 1024 (``[hd512_train]``:
    Kernels A, D, E and F launched 9, 9, 4 and 4 times a step, B and I 0;
    the loss falls) and serves 8 requests (``[hd512_serve]``: A, B at
    head_dim 512 with GQA 4:1 for the prefills, C on its vector path for
    the decode steps), as :func:`_train_then_serve` says. Returns the
    launches of both paths."""
    return _train_then_serve("hd512", HD512, HD512_BATCH, HD512_SEQ,
                             HD512_KERNELS,
                             "llama-2-7b-widths-hd512-4-layers", profile)


def phase_hd512_card_vs_cpu() -> None:
    """The tiny 512-wide-head GPT (:data:`HD512_SMALL`, f32) on the card
    (Kernels E and F at DMAX 512 in f32; B and C at head_dim 512 serving
    with pages of 64) and the CPU (:func:`_small_card_vs_cpu`)."""
    _small_card_vs_cpu("hd512_card_vs_cpu", HD512_SMALL, 64, (20, 37, 70))


# ---------------------------------------------------------------------------
# Global offsets in Kernels B and I: the chunk functions, and a 4-chunk ring
# at Mistral-7B's attention widths
# ---------------------------------------------------------------------------

#: Kernels B and I through ``flash_chunk_fwd/bwd`` at global offsets:
#: (name, b, h, kvh, sq, sk, d, causal, window, global kv_lengths, q_start,
#: k_start) — a chunk before the diagonal, on it (GQA, a window, lengths
#: ending inside), straddling it (q_off -100: the first rows see no key),
#: wholly in the future (q_off <= -sq: every tile skipped), a far past that
#: a window cuts and one it skips (q_off past sk), global lengths ending
#: inside, before and after the chunk, chunk 3 of a 16k ring (positions
#: past 12288, a window of 4096 that leaves row r the keys past r) and a
#: non-causal pair whose second length ends before the chunk; every DMAX
CHUNK_CASES = [
    ("before_diagonal", 2, 4, 4, 256, 256, 64, True, None, None, 1024, 512),
    ("diagonal_gqa_window", 2, 8, 2, 300, 300, 128, True, 200, [2400, 2200],
     2100, 2100),
    ("straddling_gqa", 1, 8, 2, 256, 320, 256, True, None, None, 1000, 1100),
    ("future", 2, 4, 4, 256, 256, 64, True, None, None, 0, 1024),
    ("far_past_window_cuts", 1, 4, 2, 256, 256, 128, True, 500, None, 1000,
     600),
    ("far_past_window_skips", 1, 4, 4, 256, 256, 512, True, 300, None, 8192,
     0),
    ("kv_lengths_inside_before_after", 3, 4, 2, 200, 256, 64, True, None,
     [600, 300, 2000], 1024, 512),
    ("ring_chunk3_of_16k", 2, 4, 2, 256, 256, 128, True, 4096,
     [16384, 10000], 12288, 8192),
    ("full_kv_lengths_end_before", 2, 4, 4, 128, 192, 512, False, None,
     [4200, 1000], 0, 4096),
]
#: the cases whose chunk sees no key at all
CHUNK_EMPTY = ("future", "far_past_window_skips")


def phase_flash_chunk() -> dict:
    """Kernels B and I at global offsets (``[flash_chunk]`` lines), each
    launched through ``flash_chunk_fwd`` / ``flash_chunk_bwd`` and held to
    its plain chunk version (:data:`CHUNK_CASES`, f32, bf16 and fp16): o
    f32 atol 2e-5 or 1 ulp of the plain version run in fp32, lse 1e-4 (the
    1e30 rows equal), grads on a given lse and delta (the plain lse + 0.25
    and 0.75 rowsum(do o): not the chunk's own) f32 atol 1e-4 or 1 ulp plus
    the rounding slack over ``backward_floor(d)``; a chunk that sees no key
    gives lse 1e30 and zeros; two runs bitwise equal. Returns the phase's
    launch counts."""
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.ops.attention import (
        backward_floor, flash_bwd_rounding_slack, flash_chunk_bwd,
        flash_chunk_bwd_plain, flash_chunk_fwd, flash_chunk_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(25)
    torch.cuda.synchronize()
    reset_launches()
    calls = 0
    for (name, b, h, kvh, sq, sk, d, causal, window, kvl, q_start,
         k_start) in CHUNK_CASES:
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        args = (kvl_t, 1.0 / math.sqrt(d), causal, window, q_start, k_start)
        kw = dict(q_start=q_start, k_start=k_start, causal=causal,
                  window=window, kv_lengths=kvl_t, softmax_scale=args[1])
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, do = (torch.randn(b, h, sq, d, device="cuda",
                                 generator=gen).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, kvh, sk, d, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
            o, lse = flash_chunk_fwd(q, k, v, **kw)
            ro, rlse = flash_chunk_fwd_plain(q.float(), k.float(), v.float(),
                                             *args)
            pad = rlse > 1e29
            lse_g = torch.where(pad, torch.zeros_like(rlse), rlse + 0.25)
            delta_g = 0.75 * (do.float() * ro.to(dtype).float()).sum(-1)
            got = flash_chunk_bwd(q, k, v, do, lse_g, delta_g, **kw)
            want = flash_chunk_bwd_plain(q, k, v, do, lse_g, delta_g, *args)
            calls += 1
            half = dtype != torch.float32
            if half:
                b_err, b_ulps, *_ = _half_check("b", name, o, ro.to(dtype),
                                                None)
            else:
                b_err, b_ulps = float((o - ro).abs().max()), 0.0
                if b_err > 2e-5:
                    raise AssertionError(f"flash_chunk {name} f32: o err "
                                         f"{b_err} > 2e-5")
            lse_err = float((lse - rlse).abs().max())
            if lse_err > 1e-4 or not torch.equal(lse > 1e29, pad):
                raise AssertionError(f"flash_chunk {name} {dtype}: lse err "
                                     f"{lse_err}")
            slack = (flash_bwd_rounding_slack(q, k, v, do, None, lse_g,
                                              *args, delta=delta_g)
                     if half else (None,) * 3)
            i_err = i_ulps = i_past = 0.0
            for g_, w_, sl in zip(got, want, slack):
                e_, u_, p_, *_ = _half_check("i", name, g_, w_, sl,
                                             backward_floor(d))
                i_err, i_ulps, i_past = (max(i_err, e_), max(i_ulps, u_),
                                         max(i_past, p_))
            if name in CHUNK_EMPTY and (not bool(pad.all()) or o.any() or
                                        any(g_.any() for g_ in got)):
                raise AssertionError(f"flash_chunk {name}: a chunk that "
                                     f"sees no key is not lse 1e30 and 0")
            same = torch.equal(o, flash_chunk_fwd(q, k, v, **kw)[0]) and all(
                torch.equal(a, g_) for a, g_ in zip(
                    flash_chunk_bwd(q, k, v, do, lse_g, delta_g, **kw), got))
            if not same:
                raise AssertionError(f"flash_chunk {name} {dtype}: two runs "
                                     f"differ")
            log("flash_chunk", kernels="b,i", case=name,
                shape=f"b{b}_h{h}_kvh{kvh}_sq{sq}_sk{sk}_d{d}",
                q_start=q_start, k_start=k_start, causal=causal,
                window=window, kv_lengths=None if kvl is None else
                json.dumps(kvl).replace(" ", ""), dtype=str(dtype)[6:],
                empty_rows=int(pad.sum()), b_max_abs_err=f"{b_err:.3e}",
                b_ulps=b_ulps, lse_err=f"{lse_err:.2e}",
                i_max_abs_err=f"{i_err:.3e}", i_ulps=i_ulps,
                i_share_past_1_ulp=f"{i_past:.2e}", repeat_bitwise=same,
                o_sha256=digest(o),
                sha256=digest(torch.cat([t.reshape(-1) for t in got])))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want_counts = {n: 2 * calls if n in ("flash_fwd", "flash_bwd") else 0
                   for n in launches}
    if launches != want_counts:
        raise AssertionError(f"flash_chunk: launches {launches}, expected "
                             f"{want_counts}")
    log("flash_chunk_launches", card=_card_name().replace(" ", "_"),
        launches=json.dumps(launches).replace(" ", ""))
    return launches


#: Mistral-7B-v0.1's attention (its config.json: 32 query heads over 8 K/V
#: heads, head_dim 128, sliding window 4096) over a global sequence of
#: 16384 in 4 chunks of 4096, b 2, global kv_lengths (16384, 10000), causal
RING = dict(b=2, h=32, kvh=8, d=128, window=4096, s=16384, cp=4,
            kv_lengths=(16384, 10000))
#: every f32 ring grad element, every head, within this share of the
#: grad's largest |value| from the non-ring flash: both sum up to 4096 x 4
#: terms in fp32 in different orders; sound runs read at most 2.80e-6 (dk)
RING_F32_GRAD_BAR = 1e-5


class _PlainChunks:
    """The plain chunk versions with ``flash_chunk_fwd``'s and
    ``flash_chunk_bwd``'s signatures, set as a ``_LocalRing``'s ``fwd``
    and ``bwd`` (:func:`_plain_ring`) on any device: the schedule a 16-bit
    ring is held to (over the kernels on the card, or the JAX package's
    ring on the CPU). The backward also sums, for each output chunk (keys
    ``("q", q_start)``, ``("k", k_start)``, ``("v", k_start)``), every
    call's |grad| and rounding slack (``flash_bwd_rounding_slack``), the
    terms of :meth:`grad_bar`."""

    def __init__(self):
        self.abs, self.slack, self.calls = {}, {}, {}

    def fwd(self, q, k, v, *, q_start, k_start, causal, window, kv_lengths,
            softmax_scale):
        from apex_tpu_torch.ops.attention import flash_chunk_fwd_plain
        return flash_chunk_fwd_plain(q, k, v, kv_lengths, softmax_scale,
                                     causal, window, q_start, k_start)

    def bwd(self, q, k, v, do, lse, delta, *, q_start, k_start, causal,
            window, kv_lengths, softmax_scale):
        from apex_tpu_torch.ops.attention import (flash_bwd_rounding_slack,
                                                  flash_chunk_bwd_plain)
        args = (kv_lengths, softmax_scale, causal, window, q_start, k_start)
        grads = flash_chunk_bwd_plain(q, k, v, do, lse, delta, *args)
        slack = flash_bwd_rounding_slack(q, k, v, do, None, lse, *args,
                                         delta=delta)
        for key, g, sl in zip((("q", q_start), ("k", k_start),
                               ("v", k_start)), grads, slack):
            self.abs[key] = self.abs.get(key, 0.0) + g.float().abs()
            self.slack[key] = self.slack.get(key, 0.0) + sl
            self.calls[key] = self.calls.get(key, 0) + 1
        return grads

    def grad_bar(self, name: str, start: int, want: torch.Tensor):
        """How far another 16-bit ring's grad of output chunk ``(name,
        start)`` may lie from ``want``, this schedule's, on the same
        residuals: each chunk call's grads within 1 ulp (eps of the
        magnitude, floored at ``backward_floor(d)``) plus its rounding
        slack, summed in fp32 in one order by both, then one rounding:
        ``eps (|want| + A + n floor) (1 + 2^-6) + S``, A and S the calls'
        |grad| and slack, n the calls."""
        from apex_tpu_torch.ops.attention import backward_floor
        key = (name, start)
        eps = torch.finfo(want.dtype).eps
        floor = backward_floor(want.shape[-1]) * eps
        return (eps * (want.float().abs() + self.abs[key])
                + self.calls[key] * floor) * (1 + 2.0 ** -6) \
            + self.slack[key]


def _plain_ring(cp: int, plain: _PlainChunks):
    """``_LocalRing``'s schedule for ``cp`` ranks over ``plain``'s chunk
    calls."""
    from apex_tpu_torch.ops.ring_attention import _LocalRing
    ring = _LocalRing(cp)
    ring.fwd, ring.bwd = plain.fwd, plain.bwd
    return ring


def _o_bar(want: torch.Tensor, m_abs: torch.Tensor) -> torch.Tensor:
    """How far another 16-bit ring's o may lie from ``want`` (a ring's o
    over the same chunks): each chunk's o within 1 ulp (eps (|o_j| +
    2^-8)) and its lse within 1e-4 (each merge weight within 2e-4
    relative), merged in fp32 with weights w_j <= 1 and rounded once:
    ``eps (|want| + M + 2^-8) (1 + 2^-6) + 2e-4 M``, ``m_abs`` = M =
    attention(q, k, |v|) >= sum_j w_j |o_j|."""
    eps = torch.finfo(want.dtype).eps
    return eps * (want.float().abs() + m_abs + 2.0 ** -8) * (1 + 2.0 ** -6) \
        + 2e-4 * m_abs


def ring_vs_plain_ring(qs, ks, vs, dos, kv_lengths, window) -> dict:
    """A 16-bit kernel ring (``_LocalRing``'s schedule over Kernels B and
    I, causal) against the same schedule over the plain chunk versions
    (``_PlainChunks``) on the same chunks, with bars derived from the
    chunk bars: o within ``_o_bar`` (each chunk's o 1 ulp and lse 1e-4,
    merged in fp32; M = attention(q, k, |v|) from Kernel B in f32 over
    the whole sequence), and, both backwards on the kernel ring's o and
    lse, each grad within ``_PlainChunks.grad_bar`` (each chunk call's 1
    ulp plus rounding slack, summed). Raises past a bar; returns each
    output's largest share of its bar."""
    from apex_tpu_torch.ops.attention import flash_fwd_cuda
    from apex_tpu_torch.ops.ring_attention import (_LocalRing, _ring_bwd,
                                                   _ring_fwd)
    cp, sc, d = len(qs), qs[0].shape[2], qs[0].shape[3]
    scale = 1.0 / math.sqrt(d)
    plain = _PlainChunks()
    kernel_ring, plain_ring = _LocalRing(cp), _plain_ring(cp, plain)
    args = (kv_lengths, True, window, scale)
    with torch.no_grad():
        os, lses = _ring_fwd(kernel_ring, qs, ks, vs, *args)
        want_os, _ = _ring_fwd(plain_ring, qs, ks, vs, *args)
        grads = _ring_bwd(kernel_ring, qs, ks, vs, kv_lengths, os, lses,
                          dos, True, window, scale)
        want_grads = _ring_bwd(plain_ring, qs, ks, vs, kv_lengths, os, lses,
                               dos, True, window, scale)
        m_abs = flash_fwd_cuda(*(torch.cat(t, dim=2).float()
                                 for t in (qs, ks)),
                               torch.cat(vs, dim=2).float().abs(), kv_lengths,
                               scale, True, window)[0].chunk(cp, dim=2)
    use = {}
    for r in range(cp):
        use[f"o{r}"] = float(((os[r].float() - want_os[r].float()).abs()
                              / _o_bar(want_os[r], m_abs[r])).max())
        for name, got_l, want_l in zip("qkv", grads, want_grads):
            bar = plain.grad_bar(name, r * sc, want_l[r])
            use[f"d{name}{r}"] = float(((got_l[r].float()
                                         - want_l[r].float()).abs()
                                        / bar).max())
    worst = max(use, key=use.get)
    if use[worst] > 1.0 or not all(torch.isfinite(t).all() for t in
                                   (*os, *grads[0], *grads[1], *grads[2])):
        raise AssertionError(f"ring vs plain ring {qs[0].dtype}: {worst} at "
                             f"{use[worst]:.4f} of its bar")
    return use


def _chunk_bytes_ops(q, k, v, kvl, window, q_start, k_start, bwd) -> tuple:
    """The bytes a chunk call must move and its visible (query, key) pairs
    times the head count (each (b, h) row counted by the mask at its
    offsets)."""
    from apex_tpu_torch.ops.attention import _visible
    sq, sk = q.shape[2], k.shape[2]
    pairs = int(_visible(sq, sk, kvl, True, window, "cuda", q_start,
                         k_start).expand(q.shape[0], 1, sq, sk).sum())
    esz = q.element_size()
    lse = q.shape[0] * q.shape[1] * sq * 4
    if bwd:    # q, do, dq; k, v, dk, dv; lse and the given delta
        return (3 * q.numel() + 4 * k.numel()) * esz + 2 * lse, \
            10.0 * q.shape[3] * q.shape[1] * pairs
    return (2 * q.numel() + 2 * k.numel()) * esz + lse, \
        4.0 * q.shape[3] * q.shape[1] * pairs


def _exact_head_group(q, k, v, do, kv_len: int, window: int) -> tuple:
    """Exact (float64) attention of one batch row over one K/V head's
    query heads, a query head at a time: q, do ``[hq, s, d]``, k, v ``[s,
    d]``, causal with a window and a length. Returns (dq ``[hq, s, d]``,
    dk, dv ``[s, d]``); a row that sees no key gives zeros."""
    s, d = k.shape
    scale = 1.0 / math.sqrt(d)
    idx = torch.arange(s, device=q.device)
    valid = (idx[None, :] <= idx[:, None]) & (
        idx[None, :] > idx[:, None] - window) & (idx[None, :] < kv_len)
    k64, v64 = k.double(), v.double()
    dk, dv, dqs = torch.zeros_like(k64), torch.zeros_like(v64), []
    for hq in range(q.shape[0]):
        q64, do64 = q[hq].double(), do[hq].double()
        p = (q64 @ k64.T).mul_(scale).masked_fill_(~valid, float("-inf"))
        p = torch.softmax(p, dim=-1).nan_to_num_(0.0)
        delta = (do64 * (p @ v64)).sum(-1, keepdim=True)
        ds = (do64 @ v64.T).sub_(delta).mul_(p)
        dqs.append(scale * (ds @ k64))
        dk += scale * (ds.T @ q64)
        dv += p.T @ do64
        del p, ds
    return torch.stack(dqs), dk, dv


def _ring_exact_check(q, k, v, do, ring_grads, flash_grads, kvl,
                      window) -> dict:
    """The f32 ring's and the non-ring flash's grads against exact
    (float64) attention, for each batch row's first K/V head and its
    query heads: each error as a share of that grad's largest |value|.
    The ring passes when its share is at most 1e-6 or twice the non-ring
    flash's, whose sums run in one fp32 order over up to 4096 keys (the
    ring's only adds a merge and a sum over chunks). Raises past that;
    returns the shares as log fields."""
    group = q.shape[1] // k.shape[1]
    err = {}
    for bb in range(q.shape[0]):
        exact = _exact_head_group(q[bb, :group], k[bb, 0], v[bb, 0],
                                  do[bb, :group], int(kvl[bb]), window)
        for name, ex, rg, fg in zip("qkv", exact, ring_grads, flash_grads):
            sel = slice(0, group) if name == "q" else 0
            rg, fg = rg[bb, sel].double(), fg[bb, sel].double()
            top = float(ex.abs().max())
            for who, g_ in (("ring", rg), ("flash", fg)):
                key = f"d{name}_{who}_vs_exact_over_max"
                err[key] = max(err.get(key, 0.0),
                               float((g_ - ex).abs().max()) / top)
        del exact
    for name in "qkv":
        ring, flash = (err[f"d{name}_{w}_vs_exact_over_max"]
                       for w in ("ring", "flash"))
        if ring > max(1e-6, 2 * flash):
            raise AssertionError(f"ring f32: d{name} {ring:.3e} of its "
                                 f"largest |value| from exact attention, "
                                 f"non-ring flash {flash:.3e}")
    return {k_: f"{e:.3e}" for k_, e in err.items()}


def phase_ring(timer: Timer) -> tuple:
    """A 4-chunk ring at Mistral-7B's attention widths (:data:`RING`)
    through ``_ring_attention_local``, all four ranks on one card (the
    same chunk calls in the same order as a 4-rank group ring), forward
    and backward under autograd, in f32 and bf16 (``[ring]`` lines). Each
    rank meets its diagonal chunk, one the window cuts, a far past the
    window skips (q_off past sk + window) and future chunks. The launches
    are read around the bf16 run (the main path of the offset records):
    B and I 16 each (cp x cp chunk calls), every other kernel 0.

    - f32: o against the non-ring ``flash_attention`` over the whole
      sequence (Kernels B and I at the default offsets) rtol and atol
      2e-5; every grad element, every head, within
      :data:`RING_F32_GRAD_BAR` of that grad's largest |value| from
      non-ring flash; and both held to exact (float64) attention on one
      K/V head group by :func:`_ring_exact_check`;
    - bf16: :func:`ring_vs_plain_ring`'s derived bars;
    - rows that see no key (batch row 1 past 14095: the window ends
      before its length) give o = 0.

    Then, in bf16, the ring's forward and forward + backward timed beside
    the non-ring flash, and rank 3's chunk calls (diagonal, window-cut,
    the two far-past ones) and rank 0's future ones timed alone, B's and
    I's diagonal call beside its plain version, its bound and SDPA with a
    boolean mask: the records ``flash_fwd_ring`` and ``flash_bwd_ring``.
    Returns (records, launches)."""
    from apex_tpu_torch.ops import LAUNCHES, flash_attention, reset_launches
    from apex_tpu_torch.ops.attention import (
        _visible, flash_chunk_bwd, flash_chunk_bwd_plain, flash_chunk_fwd,
        flash_chunk_fwd_plain, flash_fwd_cuda)
    from apex_tpu_torch.ops.ring_attention import _ring_attention_local
    card = _card_name().replace(" ", "_")
    b, h, kvh, d, w, s, cp = (RING[n] for n in ("b", "h", "kvh", "d",
                                                "window", "s", "cp"))
    sc = s // cp
    kvl = torch.tensor(RING["kv_lengths"], device="cuda")
    kw = dict(causal=True, sliding_window=w, kv_lengths=kvl)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lengths = ",".join(str(n) for n in RING["kv_lengths"])
    shape = (f"q[{b},{h},{s},{d}]_k,v[{b},{kvh},{s},{d}]_cp{cp}_window{w}_"
             f"kv_lengths[{lengths}]")
    launches, recs = None, []
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(
            dtype) for _ in range(2))
        k, v = (torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(
            dtype) for _ in range(2))
        qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(cp, dim=2)]
                           for t in (q, k, v, do))
        leaves = [[c.clone().requires_grad_() for c in chunks]
                  for chunks in (qs, ks, vs)]
        torch.cuda.synchronize()
        reset_launches()
        outs = _ring_attention_local(*leaves, **kw)
        torch.autograd.backward(outs, dos)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        want = {n: cp * cp if n in ("flash_fwd", "flash_bwd") else 0
                for n in counts}
        if counts != want:
            raise AssertionError(f"ring {dtype}: launches {counts}, "
                                 f"expected {want}")
        o = torch.cat([t.detach() for t in outs], dim=2)
        grads = [torch.cat([c.grad for c in chunks], dim=2)
                 for chunks in leaves]
        empty = int(RING["kv_lengths"][1]) + w
        if o[1, :, empty:].any():
            raise AssertionError("ring: rows that see no key are not 0")
        fields = {}
        if dtype == torch.float32:
            fl = [t.clone().requires_grad_() for t in (q, k, v)]
            fo = flash_attention(*fl, **kw)
            fo.backward(do)
            fo = fo.detach()
            o_err = float(((o - fo).abs() - 2e-5 * fo.abs()).max())
            if o_err > 2e-5:
                raise AssertionError(f"ring f32: o past rtol/atol 2e-5 "
                                     f"({o_err})")
            fields["o_err"] = f"{float((o - fo).abs().max()):.3e}"
            for name, g_, f_ in zip("qkv", grads, fl):
                share = float((g_ - f_.grad).abs().max()
                              / f_.grad.abs().max())
                if share > RING_F32_GRAD_BAR:
                    raise AssertionError(
                        f"ring f32: d{name} {share:.3e} of its largest "
                        f"|value| from non-ring flash (bar "
                        f"{RING_F32_GRAD_BAR:.0e})")
                fields[f"d{name}_vs_flash_over_max"] = f"{share:.3e}"
            fields.update(_ring_exact_check(q, k, v, do, grads,
                                            [f_.grad for f_ in fl], kvl, w))
            del fl, fo
        else:
            launches = counts
            use = ring_vs_plain_ring(qs, ks, vs, dos, kvl, w)
            fields = {f"{n}_bar_use": f"{u:.4f}" for n, u in use.items()}
        log("ring", card=card, shape=shape, dtype=str(dtype)[6:],
            launches=json.dumps(counts).replace(" ", ""),
            o_sha256=digest(o),
            sha256=digest(torch.cat([g_.reshape(-1) for g_ in grads])),
            **fields)
        del outs, leaves, grads, o
        torch.cuda.empty_cache()
    # times (bf16): the ring against the non-ring flash
    with torch.no_grad():
        ring_fwd = timer(lambda: _ring_attention_local(qs, ks, vs, **kw),
                         iters=5, warmup=1)
        flash_fwd = timer(lambda: flash_attention(q, k, v, **kw), iters=5,
                          warmup=1)
    leaves = [[c.clone().requires_grad_() for c in chunks]
              for chunks in (qs, ks, vs)]

    def ring_step():
        torch.autograd.backward(_ring_attention_local(*leaves, **kw), dos)

    fl = [t.clone().requires_grad_() for t in (q, k, v)]
    ring_both = timer(ring_step, iters=5, warmup=1)
    flash_both = timer(lambda: flash_attention(*fl, **kw).backward(do),
                       iters=5, warmup=1)
    log("ring_timed", card=card, shape=shape, dtype="bfloat16",
        ring_fwd_ms=f"{ring_fwd:.5f}", ring_bwd_ms=f"{ring_both - ring_fwd:.5f}",
        ring_fwd_bwd_ms=f"{ring_both:.5f}", flash_fwd_ms=f"{flash_fwd:.5f}",
        flash_bwd_ms=f"{flash_both - flash_fwd:.5f}",
        flash_fwd_bwd_ms=f"{flash_both:.5f}")
    # one forward + backward of the ring, device ms by kernel
    ops, dev_ms, by_kernel = device_work(ring_step)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    log("ring_profile", card=card, device_ops=ops, device_ms=dev_ms,
        top=json.dumps({n[:48]: [c, round(ms, 5)] for n, (c, ms) in top})
        .replace(" ", ""))
    del leaves, fl
    # rank 3's chunk calls and rank 0's future ones, alone, on the global
    # lse and delta
    o_full, lse_full = flash_fwd_cuda(q, k, v, kvl, 1.0 / math.sqrt(d), True,
                                      w)
    delta = (do.float() * o_full.float()).sum(-1)
    lse_c, delta_c = ([t[:, :, r * sc:(r + 1) * sc].contiguous()
                       for r in range(cp)] for t in (lse_full, delta))
    for r, j, kind in ((3, 3, "diagonal"), (3, 2, "window_cuts"),
                       (3, 1, "far_past_skipped"), (3, 0, "far_past_skipped"),
                       (0, 1, "future"), (0, 3, "future")):
        ckw = dict(q_start=r * sc, k_start=j * sc, causal=True, window=w,
                   kv_lengths=kvl, softmax_scale=1.0 / math.sqrt(d))
        args = (qs[r], ks[j], vs[j])
        bargs = (*args, dos[r], lse_c[r], delta_c[r])
        ms_b = timer(lambda: flash_chunk_fwd(*args, **ckw), iters=10)
        ms_i = timer(lambda: flash_chunk_bwd(*bargs, **ckw), iters=10)
        fields = {}
        if kind == "diagonal":
            pargs = (kvl, ckw["softmax_scale"], True, w, r * sc, j * sc)
            plain_b = timer(lambda: flash_chunk_fwd_plain(*args, *pargs),
                            iters=3, warmup=1)
            plain_i = timer(lambda: flash_chunk_bwd_plain(*bargs, *pargs),
                            iters=3, warmup=1)
            mask = _visible(sc, sc, kvl, True, w, "cuda", r * sc, j * sc)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs[r], ks[j], vs[j], attn_mask=mask, enable_gqa=True)
            lib_b = timer(sdpa, iters=10)
            q4, k4, v4 = (t.detach().clone().requires_grad_()
                          for t in args)
            out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  enable_gqa=True)
            lib_i = timer(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), dos[r], retain_graph=True), iters=10)
            del q4, k4, v4, out4, mask
            o_c, lse_o = flash_chunk_fwd(*args, **ckw)
            ro, _ = flash_chunk_fwd_plain(*(t.float() for t in args), *pargs)
            b_err = float((o_c.float() - ro.to(o_c.dtype).float()).abs().max())
            i_got = flash_chunk_bwd(*bargs, **ckw)
            i_want = flash_chunk_bwd_plain(*bargs, *pargs)
            i_err = max(float((g_.float() - w_.float()).abs().max())
                        for g_, w_ in zip(i_got, i_want))
            bb, ob = _chunk_bytes_ops(*args, kvl, w, r * sc, j * sc, False)
            bms_b, by_b = bound_ms(bb, ob, torch.bfloat16)
            bb, ob = _chunk_bytes_ops(*args, kvl, w, r * sc, j * sc, True)
            bms_i, by_i = bound_ms(bb, ob, torch.bfloat16)
            cshape = (f"q[{b},{h},{sc},{d}] k,v[{b},{kvh},{sc},{d}] bf16 "
                      f"q_start{r * sc} k_start{j * sc} window{w}")
            recs.append(dict(
                name="flash_fwd_ring", route="cuda",
                source="apex_tpu_torch/csrc/flash_fwd.cu",
                replaces="apex_tpu/ops/attention.py:266", shape=cshape,
                max_abs_err=b_err, ms=ms_b, plain_ms=plain_b,
                bound_ms=bms_b, bound_by=by_b, library_ms=lib_b))
            recs.append(dict(
                name="flash_bwd_ring", route="cuda",
                source="apex_tpu_torch/csrc/flash_bwd.cu",
                replaces="apex_tpu/ops/attention.py:438", shape=cshape,
                max_abs_err=i_err, ms=ms_i, plain_ms=plain_i,
                bound_ms=bms_i, bound_by=by_i, library_ms=lib_i))
            fields = dict(b_plain_ms=f"{plain_b:.5f}",
                          b_library_ms=f"{lib_b:.5f}",
                          b_bound_ms=f"{bms_b:.5f}", b_bound_by=by_b,
                          i_plain_ms=f"{plain_i:.5f}",
                          i_library_ms=f"{lib_i:.5f}",
                          i_bound_ms=f"{bms_i:.5f}", i_bound_by=by_i)
        log("ring_chunk_timed", card=card, rank=r, chunk=j, kind=kind,
            b_ms=f"{ms_b:.5f}", i_ms=f"{ms_i:.5f}", **fields)
    del q, k, v, do, qs, ks, vs, dos, o_full, lse_full, delta
    torch.cuda.empty_cache()
    return recs, launches


#: the phase whose run is each kernel's main path
MAIN_PATH = {"layer_norm_fwd": "serve", "flash_fwd": "serve",
             "paged_decode": "serve", "layer_norm_bwd": "train",
             "flash_packed_fwd": "train", "flash_packed_bwd": "train",
             "softmax_fwd": "bert_train", "softmax_bwd": "bert_train",
             "flash_bwd": "t5_train", "conv1x1_fwd": "rn50_train",
             "conv1x1_bwd": "rn50_train", "conv3x3_fwd": "rn50_train",
             "conv3x3_bwd": "rn50_train", "paged_decode_int8": "serve_int8",
             "paged_decode_window": "serve_spec",
             "multi_tensor_scale": "train_amp",
             "multi_tensor_l2norm": "bert_train",
             "multi_tensor_adam": "train_amp",
             "multi_tensor_lamb": "bert_train",
             "multi_tensor_sgd": "rn50_train",
             "layer_norm_fwd_fp16": "train_fp16",
             "layer_norm_bwd_fp16": "train_fp16",
             "flash_packed_fwd_fp16": "train_fp16",
             "flash_packed_bwd_fp16": "train_fp16",
             "flash_fwd_fp16": "serve_fp16",
             "paged_decode_fp16": "serve_fp16",
             "softmax_fwd_fp16": "bert_train_fp16",
             "softmax_bwd_fp16": "bert_train_fp16",
             "flash_bwd_fp16": "t5_train_fp16",
             "conv1x1_fwd_fp16": "rn50_train_fp16",
             "conv1x1_bwd_fp16": "rn50_train_fp16",
             "conv3x3_fwd_fp16": "rn50_train_fp16",
             "conv3x3_bwd_fp16": "rn50_train_fp16",
             "flash_packed_fwd_hd256": "gemma2b_train",
             "flash_packed_bwd_hd256": "gemma2b_train",
             "flash_fwd_hd256": "gemma2b_serve",
             "flash_bwd_hd256": "flash_hd256",
             "paged_decode_hd256": "gemma2b_serve",
             "layer_norm_fwd_wide": "llama405b_serve",
             "flash_packed_fwd_hd512": "hd512_train",
             "flash_packed_bwd_hd512": "hd512_train",
             "flash_fwd_hd512": "hd512_serve",
             "flash_bwd_hd512": "flash_hd512",
             "paged_decode_hd512": "hd512_serve",
             "flash_fwd_ring": "ring", "flash_bwd_ring": "ring"}
#: the launch counter of a record that names a variant of a kernel
COUNTER = {"paged_decode_int8": "paged_decode",
           "paged_decode_window": "paged_decode",
           "layer_norm_fwd_fp16": "layer_norm_fwd",
           "layer_norm_bwd_fp16": "layer_norm_bwd",
           "flash_packed_fwd_fp16": "flash_packed_fwd",
           "flash_packed_bwd_fp16": "flash_packed_bwd",
           "flash_fwd_fp16": "flash_fwd",
           "paged_decode_fp16": "paged_decode",
           "softmax_fwd_fp16": "softmax_fwd",
           "softmax_bwd_fp16": "softmax_bwd",
           "flash_bwd_fp16": "flash_bwd",
           "conv1x1_fwd_fp16": "conv1x1_fwd",
           "conv1x1_bwd_fp16": "conv1x1_bwd",
           "conv3x3_fwd_fp16": "conv3x3_fwd",
           "conv3x3_bwd_fp16": "conv3x3_bwd",
           "flash_packed_fwd_hd256": "flash_packed_fwd",
           "flash_packed_bwd_hd256": "flash_packed_bwd",
           "flash_fwd_hd256": "flash_fwd",
           "flash_bwd_hd256": "flash_bwd",
           "paged_decode_hd256": "paged_decode",
           "layer_norm_fwd_wide": "layer_norm_fwd",
           "flash_packed_fwd_hd512": "flash_packed_fwd",
           "flash_packed_bwd_hd512": "flash_packed_bwd",
           "flash_fwd_hd512": "flash_fwd",
           "flash_bwd_hd512": "flash_bwd",
           "paged_decode_hd512": "paged_decode",
           "flash_fwd_ring": "flash_fwd", "flash_bwd_ring": "flash_bwd"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the serve and train phases, trace a "
                        "second serve (of each serve phase) and two more "
                        "steps of each train phase with torch.profiler and "
                        "print their breakdowns")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the sampled requests' seeds")
    args = parser.parse_args()
    phase_device()
    # fp32 comparisons hold to fp32 GEMMs, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    timer = Timer()
    records = [phase_layer_norm(timer), phase_layer_norm_fp16(timer),
               *phase_flash(timer), *phase_decode(timer),
               phase_layer_norm_bwd(timer), phase_layer_norm_bwd_fp16(timer),
               phase_layer_norm_wide(timer),
               *phase_packed(timer), *phase_softmax(timer),
               *phase_flash_bwd(timer), *phase_conv(timer),
               *phase_multi_tensor(timer)]
    hd256_records, hd256_launches = phase_flash_hd256(timer)
    records += hd256_records
    hd512_records, hd512_launches = phase_flash_hd512(timer)
    records += hd512_records
    records.append(phase_decode_hd512(timer))
    paths = {"serve": phase_serve(args.profile)}
    for name, knobs, kind in SERVE_FEATURES:
        paths[name] = phase_serve_feature(name, knobs, kind, args.profile)
    paths.update(phase_serve_paths(args.seed, args.profile))
    paths["serve_fp16"] = phase_serve_fp16(args.profile)
    phase_card_vs_cpu()
    phase_features_card_vs_cpu()
    phase_serving_paths_card_vs_cpu(args.seed)
    phase_serve_fp16_card_vs_cpu()
    paths["train"] = phase_train(args.profile)
    phase_train_card_vs_cpu()
    paths["train_amp"] = phase_train_amp(args.profile)
    paths["train_fp16"] = phase_train_fp16(args.profile)
    phase_amp_card_vs_cpu()
    paths["bert_train"] = phase_bert_train(args.profile)
    paths["bert_train_fp16"] = phase_bert_train_fp16(args.profile)
    paths["t5_train"] = phase_t5_train(args.profile)
    paths["t5_train_fp16"] = phase_t5_train_fp16(args.profile)
    phase_enc_card_vs_cpu()
    paths["rn50_train"] = phase_rn50_train(args.profile)
    paths["rn50_train_fp16"] = phase_rn50_train_fp16(args.profile)
    phase_rn50_card_vs_cpu()
    paths["flash_hd256"] = hd256_launches
    paths.update(phase_gemma2b(args.profile))
    phase_hd256_card_vs_cpu()
    paths["llama405b_serve"] = phase_llama405b_serve(args.profile)
    phase_wide_card_vs_cpu()
    paths.update(phase_train_features(args.profile))
    phase_train_features_card_vs_cpu()
    paths["flash_hd512"] = hd512_launches
    paths.update(phase_hd512(args.profile))
    phase_hd512_card_vs_cpu()
    paths["flash_chunk"] = phase_flash_chunk()
    ring_records, paths["ring"] = phase_ring(timer)
    records += ring_records
    for rec in records:
        name = rec["name"]
        counter = COUNTER.get(name, name)
        rec["launches"] = paths[MAIN_PATH[name]][counter]
        rec["launches_by_path"] = {path: counts[counter]
                                   for path, counts in paths.items()}
    kernels = [{k: rec[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
        "launches_by_path")} for rec in records]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
