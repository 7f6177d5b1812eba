#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flash_attention_cute_tpu_torch) on
one NVIDIA Hopper card.

    python3 chip_smoke.py              # every model at full depth
    python3 chip_smoke.py --layers 4   # depth cut (printed), widths unchanged

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card of compute capability 9.0; its name and power limit.
  2. build: every kernel of the main paths from csrc/ (one nvcc per source,
     all at once), with the ptxas register / shared-memory / spill report
     and, for every B10 / B11, P / B2, B4, D1, B7, B5, B6, B8, B9, B12 and
     B13a / B13b instantiation, the runtime's registers, spill bytes and launch
     shared memory (no spill allowed); then the native scheduler
     (csrc/page_allocator.cpp) with g++.
  3. kernels vs plain: P / B2 with their lse (PREFILL_CASES: the main
     path's B 4 S 512, S 1, 63, 65, 130 and 1000 at the edges of the
     kernel's 128-row blocks and 128-key tiles, Sq 64 / Skv 1000, Sq 1000 /
     Skv 64 and Sq 1024 / Skv 256 with rows of no key (exact zeros, lse
     +inf), GQA groups 1, 7 and 32, f16, non-causal, windows of 1, 45 and
     400 keys, transposed q / k / v views; every call repeated, output and
     lse bit for bit), D1, D2, B5 (paged decode) and the paged append at
     Llama-3-8B attention widths against their plain PyTorch versions on
     the card (bf16; tolerance below), B6 (paged extend) over
     EXTEND_CASES (page sizes 8 / 16 / 128, D 64 / 128 / 256, S 1 to 512,
     offsets off the tiles, windows 1 / 45 / 4096, groups 1 / 7 / 8, f16,
     an inactive row of exact zeros, every call repeated bit for bit), B5 /
     B6 over NaN-poisoned pools behind permuted page tables, and D1 + D2
     over CONTIG_DECODE_CASES["llama"] (D 64 / 128, groups 1-32,
     capacities no multiple of 4 or of a tile, lengths 0, 1, 37, C - 1, C,
     NaN tails, the stacked cache, every call repeated bit for bit); then
     (3b) the
     quantized-cache kernels B7 (decode), B8 (paged decode), B9 (paged
     extend, over EXTEND_CASES, int8 and e4m3 in turn; B7 also over
     CONTIG_DECODE_CASES["llama"]) over int8 and e4m3
     values whose scales (and e4m3 values) hold NaN at and past every
     length, and QA (quantize-and-append, paged and contiguous), which must
     be bit-identical to its plain version; (3c)
     the weight-only quantized products B10 (int8) and B11 (int4) at the
     Llama-3-8B projection shapes (T 1 to 2048, either side of the decode /
     prefill crossover at 16 / 17, a verify round of 20, 63 / 64, a chunk
     of 256, the padded lm_head, a ragged K, an int4 K_pad of 256, f16, x
     rows TMA cannot take) against their plain versions, each on the
     plan's route and, where the plan splits K, in one pass over K, every
     output repeated bit for bit; (3d) the
     contiguous extend B4 in bf16 and f16 at the verify shape (B 4, S 5,
     capacity 640, q_offset 0-600), a chunk (S 256, q_offset 0-768,
     capacity 1100), with a kv_length-0 row (exact zeros), non-causal and
     at D 64, over caches NaN at and past every kv_length, q/k/v transposed
     views; the soft caps 30 / 50 / 1.0, D 256 and the window of 4096 at
     Gemma-2-9B's widths (16 / 8), and Qwen2-7B's group of 7 at S 5 (seven
     heads packed in a block) and S 20 (one head a block); every call
     repeated bit for bit; (3e) sliding windows of 1, 100 (an edge inside a 64-key tile),
     4096 and 8192 (at least every length): B2 (windowed prefill; P where
     the window cannot bind) at S 5120, 1000 and Sq 256 / Skv 1024, and D1 +
     D2 (splits below the window dead) at Mistral-7B's (32 / 8) and
     Qwen2-7B's (28 / 4, group 7) widths, D1 + D2 and B7 + D2 over
     CONTIG_DECODE_CASES["window"]; B4, B5, B6, B7, B8, B9 windowed at
     Mistral widths over contexts up to 5152 keys, NaN past every length;
     (3f) the training kernels: the lse of P and B2 against the plain lse
     (finite entries within LSE_TOL, the same +inf rows), then B13a (dK,
     dV) and B13b (dQ) against the plain recompute backward fed the same o,
     dO and lse, on transposed q / k / v views and a non-contiguous dO:
     causal B 2 S 2048, non-causal, windows 100 and 4096 at S 5120, Sq 256
     / Skv 1024, Sq 1024 / Skv 256 (dQ rows of exact zeros), ragged S 1000,
     D 64, f16, Qwen2-7B's 28 / 4; tiles of 128 keys and 64 rows cut short
     or ragged: S 130, Sq 64 / Skv 1000, Sq 1000 / Skv 64 (rows with no
     key), and MQA with a group of 32; each case called twice, the second
     call's dq / dk / dv bit-identical to the first's; then autograd through
     `ops.autodiff.flash_attention` against autograd through the fp32
     reference; (3g) B12 (packed ragged batch) against its plain version
     (each sequence's dense attention, run per segment) over 32 sequences of
     numpy-seeded lengths 100-2048 (one of 1 token, a total not a multiple
     of 64) at Llama widths: causal, full, kv 0-512 tokens longer, window
     256, and at Gemma-2-9B widths (D 256) with the caps 50 and 1.0, causal
     and kv longer with the window of 4096; every call repeated bit for bit;
     (3h) Gemma2's soft cap and head dim 256, at Gemma-2-9B attention
     widths (Hq 16, Hkv 8, D 256, scale 256 ** -0.5), each case with the
     model's cap 50 and with 1.0 (which binds on every score), against the
     fp32 plain versions run on q's fp32 image: P (causal B 2 S 4608, Sq 256
     / Skv 1024, ragged S 1000 in f16, Sq 1000 / Skv 64 with rows of no
     key, MQA group 16) and B2 (B 2 S 4608, window 4096), each with its lse
     (LSE_TOL) and repeated bit for bit, D1 + D2 and B7 + D2 over
     CONTIG_DECODE_CASES["gemma2"] (D 256 and 128 with the caps, groups 2,
     16 and 32, capacities 4641, 1027, 770), D1
     + D2 (capacity 4640, windows none and 4096, NaN past every length), B5,
     B6, B8 and B9 (page sizes 16 and 128, NaN-poisoned pools behind
     permuted tables, B6 / B9 with and without the window; B8 / B9 over int8
     pages of 16 and e4m3 pages of 128; B5 / B8 repeated bit for bit), the
     paged append and QA at D 256 (bit-identical), and P, D1, B5, B6, B8, B9
     with the caps at Llama widths, B5 / B8 also at a group of 32 (Hq 32,
     Hkv 1); (3i) int8 scores (`score_dtype="int8"`) over INT8_CASES
     (Llama-3-8B attention at B 4 S 512 and B 1 S 8192, Mistral-7B's B 2 S
     5120 W 4096 (B2-i8), Gemma-2-9B's D 256 with the cap 50, also with
     its window, D 64 non-causal Sq 300 / Skv 1000, f16 Sq 1000 / Skv 700
     with rows of no key; transposed views): K8 bit-identical to its plain
     version, P-i8 / B2-i8 with their lse against the plain int8 version
     (BF16_TOL, LSE_TOL), within INT8_ORACLE_TOL of the fp32 oracle of
     bf16 scores, more than INT8_MIN_DIFF from the bf16-score P / B2, and
     repeated bit for bit; then the API's int8 route (path "int8 scores"):
     `api.flash_attention_forward(score_dtype="int8")` at Llama B 4 S 512
     and Mistral B 2 S 5120 W 4096, counted (K8 2, P-i8 1, B2-i8 1, nothing
     else), each output against the plain int8 version; (3j) head dims
     outside 64 / 128 / 256, which P / B2, D1 + D2, B5, B6 and the append
     run in the layout of the next of 64, 128 and 256 (ODD_HEAD_DIMS: D 96
     at 32 / 32 heads, D 80 at 32 / 8, D 32, D 160 in f16, D 192; D 96
     also with a window and with the cap 50): each against its fp32 plain
     version, over NaN tails and poisoned pools (`poison_past`), repeated
     bit for bit, D1's partials at 5 splits, the append bit-identical;
     (3k) the same head dims in B7 + D2, B8 + D2 (page sizes 16 / 128), B9
     and QA over int8 and e4m3 values (one-byte rows, every multiple of 16
     up to 256) and in B4 (a verify round of 5 rows with a kv_length-0
     row, a chunk of 256; bf16 / f16), D 96 also windowed and capped, each
     against its fp32 plain version over NaN tails, repeated bit for bit,
     QA's whole pools bit-identical to the plain version's; D 40 over
     one-byte rows (d % 16 == 8) in B7, B8, B9 and QA and D 100 in B4,
     refused before the pitched rows, launch once each; B7, B8, B9 and
     QA (the wide layouts, 5n) launch once each at D 264 over zero values
     (zero outputs), and B4 and its partials (the wide layout, 5m), held
     to their plain versions within 3e-2 and, row by row, ROW_TOL; all of
     them refuse D 520 and D 0 before any launch; (3l) the same rule in training and packed
     batches (ODD_TRAINING_DIMS: D 8, 24, 40, 96, 136, 200 and 248, GQA
     groups 1 and 4, bf16 and f16): B13a / B13b causal, windowed with Sq <
     Skv and non-causal with Sq > Skv on transposed views, held to the
     plain backward within 2e-2 of the gradient's max, B13a also forced
     into 3 parts (within 2^-7 of one pass) and one pass, and B12 causal,
     with kv longer and a window, and full, within 3e-2, every call
     repeated bit for bit; D 100 (refused before the pitched rows) run by
     the backward, the autograd op and B12 with their launch counts, D 520
     and D 0 refused by the backward and the autograd op (they take
     257-512 in the layout of 512, 5o) and by B12 (its wide layout, 5l),
     with no launch; (3m) GQA groups above
     32 in the decodes, which cut a group into chunks of at most 32 q rows,
     a block each, and above 8 in the paged extends (LARGE_GROUP_DECODES:
     groups 33, 48 at StarCoder's 48 / 1 heads, 64, 71 at Falcon-7B's 71 /
     1 heads and over two kv heads, 128 / 1; D 64, 96, 128 and 256; windows
     of 100 and 45, the caps 50 and 1.0, f16): D1 + D2 and B7 + D2 (int8,
     e4m3) over NaN-tailed stacked caches, B5 + D2 and B8 + D2 over
     NaN-poisoned pools of page_size 16 or 128, lengths with 0 among them,
     D1's partials at 7 splits (dead splits among them) within 1e-2 of the
     plain partials; B6 and B9 (int8, e4m3) at groups 12 (96 / 8), 16 (128
     / 8, window 45) and 71 (71 / 1, D 64, cap 50, f16) with an inactive
     row; each within 3e-2 of its fp32 plain version and repeated bit for
     bit; then `api.flash_attention_forward` at Sq 1 on Falcon-7B's 71 / 1
     heads (B 8, 2048 keys, ragged lengths with a 0, NaN tails), counted on
     path "mqa-71": D1 once, D2 once, nothing else, within 3e-2 of the
     plain decode; (3n) B4's (o, m, l) partials (PARTIALS_CASES: one ring
     step's offsets S_local / 0 / -S_local, the zig-zag's half shapes at
     S_local 4096, D 96, D 256 with the cap 50, Llama-3.1-405B's group of
     16 at S 5 and 256, the window of 4096 with the cap 30, a row of
     kv_length 0, f16 S 12 (two-part P), non-causal D 64; NaN tails)
     against the plain partials: o and l within 3e-2 of l, m within 3e-2
     (`partials_err`), rows with no key m = l = o = 0, repeated bit for
     bit; also at D 100, 36 and 4 (rows at the pitch); (3o) every head dim
     from 1 to 256: a d whose rows are no whole 16 bytes runs over rows at
     the port's pitch (`_build.row_pitch`; caches, pools and outputs
     allocated so, a caller's tensor at another stride copied once by
     `_build.rows`, counted in `_build.copies`): K8 (bit-identical) and
     P-i8 / B2-i8 at D 4, 40, 96 and 100 (PITCHED_INT8_CASES) as in 3i;
     P / B2, D1 + D2, B5, B6, the append and B4 at D 4, 36 and 100
     (PITCHED_HEAD_DIMS, 32 / 8 heads; D 100 also windowed and capped) as
     in 3j / 3k; B7 + D2, B8 + D2, B9, QA and B4 at D 24, 40 and 72 over
     int8 / e4m3 (PITCHED_ONE_BYTE_DIMS; D 40 also windowed and capped) as
     in 3k; B13a / B13b and B12 at D 36 and 100 as in 3l; P-i8 (K8)
     refuses D 264 and D 0 before any launch, and P / B2, B6, D1, B5 and
     the append D 520 and D 0 (they take 257-512 in the wide layouts,
     5l-5n; B6, D1 and B5 launch once at D 264, held to their plain
     versions as B4 in 3k, and the append once);
     then the API's int8 scores at Phi-3-mini's
     widths (32 / 32 heads, D 96, path "phi3-widths int8 scores"): causal
     at B 4 x 512 and Phi-3-mini-4k's window of 2047 at B 1 x 4096,
     counted (K8 2, P-i8 1, B2-i8 1, nothing else), each output within
     3e-2 of the plain int8 version and 5e-2 of the fp32 oracle.
  4. main paths: greedy generation of Llama-3-8B (random weights from a
     seeded CUDA generator) at B 4, prompt 512, 64 new tokens; launch
     counters show the kernels carried it; teacher-forced logits of the
     kernel path agree with the plain-attention path. (4a) The same over
     an int8 KV cache (QA, B7 + D2), its decode step held to the plain
     route over one and the same quantized cache. (4b) The serving engine
     over 24 requests in seven runs: (A) whole-prompt admission, (B) chunked
     admission, (C) chunked admission in a pool small enough to preempt,
     (D) run A over int8 pages, (E) run B over e4m3 pages, (F) run A with
     int8 weights, (G) run D with fused int4 weights. Every request
     finishes, launch counts match the forwards, and every engine token is
     within 1.0 of the top logit of its request teacher-forced: one
     contiguous prefill (kernel P) for A-C and F, and for D, E and G the
     run's own admission (one prefill, or 256-token extends) then one
     extend over the generated tokens through
     `forward_paged(plain_attention=True)` on quantized pages of the run's
     dtype, which quantizes every row as the engine did; F and G are teacher-forced through the dequantized image
     of their weights. (4c) The serving forward's logits on the kernel route
     against its plain_attention route in prefill, extend and decode, over
     a bf16, an int8 and an e4m3 pool. (4d, run before 4b) Greedy
     generation with weights quantized by `quantize_params` on the card:
     (i) unfused int8 over the bf16 cache, (ii) fused int4 over an int8
     cache; B10 / B11 launched forwards x (projections x layers + 1), and
     the teacher-forced prefill and decode logits of each quantized tree
     held to those of its dequantized bf16 image (cuBLAS products). (4e)
     The extend mode: prefill 512 then extends of 5 and 59 tokens (B4)
     against one 576-token prefill, and over an int8 cache the kernel route
     against the plain route; then speculative generation at B 4, prompt
     512, 64 new tokens, gamma 4: (i) `speculative_generate` with the target
     as its own draft, (ii) with a 2-layer draft of Llama-3-8B widths, (iii)
     `prompt_lookup_generate` (ngram 2) on prompts repeating a 64-token
     segment 8 times, (iv) (i) sampled at temperature 1.0, top-k 50, twice
     with one seed (equal tokens). Launch counts per run (P: the prefills;
     B4: layers x rounds of each model; D1 + D2: draft layers x rounds x
     (gamma - 1)), every greedy token teacher-forced through one contiguous
     prefill (within 1.0 of the top logit, argmax share >= 0.9), and (i)'s
     acceptance share accepted / (rounds x gamma x B) >= 0.75.
     (4f) Mistral-7B (window 4096 on every layer; random weights from a
     seeded CUDA generator), after the Llama tree is dropped: teacher-forced
     prefill (B2) and decode-step (D1 + D2) logits at B 2, prompt 5120,
     against the plain_attention route run one row at a time; greedy
     generation of 32 tokens over a bf16 cache (B2 32 launches, D1 + D2 31 x
     32) with its prefill and decode times apart, and over an int8 cache
     (B2 32, QA 32 x 32, B7 + D2 31 x 32; its
     decode step held to the plain route over one and the same cache); the
     serving engine over 8 requests (prompts 4200-5000 tokens, 16-32 new,
     numpy seed 0, 4 slots) in runs M1 (whole-prompt admission, page_size
     128: B2, B5 + D2, the append) and M2 (chunked admission of 512-token
     chunks, page_size 16: B6, B5 + D2), every token teacher-forced through
     one contiguous prefill (B2). (4g) Qwen2-7B (non-zero q/k/v biases,
     28 / 4 heads): teacher-forced logits at B 4, prompt 512, and greedy
     generation of 32 tokens (P 28, D1 + D2 31 x 28) with its prefill and
     decode times apart. Each tree is dropped
     before the next is drawn. (4h) Training: Llama-3-8B at full width,
     depth cut to 8 layers (printed; AdamW over 32 bf16 layers needs about
     64 GB before activations), random weights from a seeded CUDA
     generator, every parameter trained: the first step's gradients on the
     plain route (`plain_attention=True`), then three `torch.optim.AdamW`
     steps (lr TRAIN_LR) of the next-token loss on one batch of B 2 x S 2048
     numpy-seeded ids; the loss falls from step 1 to step 3, every gradient
     is finite, P (with its lse), B13a and B13b launch layers x steps times
     and nothing else launches, and the first step's gradients on the
     kernel route are held to the plain route's leaf by leaf (relative norm
     error <= TRAIN_GRAD_TOL); step times, tokens/s, peak memory and the
     profiler's split of a fourth step. (4i) The varlen entry point
     (`flash_attention_varlen`) over 3g's packed batch: B12 once. (4l, run
     after 4i; launches counted as path "training Gemma 2") Training of
     Gemma 2 at Gemma-2-9B's widths with the attention cap off
     (`logit_softcap=None`; the final-logit cap 30, the window of 4096 on
     the even layers, sandwich norms, GeGLU and tied embeddings kept), depth
     cut to 8 layers (printed with the memory reckoning that sets it: 6 if
     the plain route's first step would not fit the card), as 4h does over
     one batch of B 1 x S 4608: B2 on the windowed layers and P on the
     others, B13a and B13b at D 256 on every layer, each once a step. (4j)
     Gemma-2-9B (42 layers, D 256, a window of 4096 on the even layers,
     soft caps 50 / 30, GeGLU, sandwich norms, scaled embeddings, vocabulary
     256000; random weights from a seeded CUDA generator), drawn after the
     Qwen2 tree is dropped: teacher-forced prefill logits (every 64th
     position and the last, both routes a row at a time: one 4608-token row
     of fp32 logits is 4.7 GB) and decode-step logits at B 2, prompt 4608,
     kernel route against the plain route; greedy generation of 32 tokens
     over a bf16 cache (B2 21, P 21, D1 + D2 31 x 42) with its prefill and
     decode times; over int8 and e4m3 caches the decode step, kernel route
     (QA, B7 + D2 at D 256 with the cap) against the plain route over one
     and the same cache, and greedy generation (B2 21, P 21, QA 32 x 42, B7
     + D2 31 x 42); `prompt_lookup_generate` (ngram 2, gamma 4) over a bf16
     cache at B 2 on prompts repeating a 64-token segment 8 times, 32 new
     (B4 at D 256 with the cap: layers x rounds launches, P 42), every token
     teacher-forced; the serving engine over Mistral's 8 long requests in
     runs G1 (whole-prompt, page_size 128), G2 (chunked 512, page_size 16)
     and G3 (G2 over int8 pages: B9, B8 and QA at D 256 with the cap;
     teacher-forced over int8 pages as runs D / E are), launch counts per
     forward, every token teacher-forced. (4m) A model at Phi-3-mini's
     widths (`phi3_mini_widths_config`: 32 layers, hidden 3072, 32 / 32
     heads, D 96, SwiGLU 8192, vocab 32064, untied; its sliding window of
     2047 left out, which no sequence of the phase reaches), random
     weights: teacher-forced prefill and decode-step logits at B 4, prompt
     512, kernel route against the plain route; greedy generation of 64
     tokens (P 32, D1 + D2 63 x 32); serving runs A and B over the 24
     requests (P at admission, B6, B5 + D2, the append), every token
     teacher-forced; launches on paths "phi3-widths ...", each run's
     exact; prefill ms, decode ms/token, serving wall s, tokens/s, peak GB.
     (4n, on the same tree) At Phi-3-mini's widths and full depth, paths
     "phi3-widths ...", each run's launch counts exact: greedy generation
     (B 4, prompt 512, 64 new) over an int8 and an e4m3 contiguous cache
     (P 32, QA 64 x 32, B7 + D2 63 x 32; the first decode step's kernel
     route against the plain route), serving runs D (int8 pages of 128)
     and E (e4m3 pages of 16, chunked 256) over the 24 requests (P or B9 at
     admission, B8 + D2, QA), every token teacher-forced over quantized
     pages, and speculation at gamma 4 as in 4e (a prompt drawn as 4e's,
     numpy seed 0): self-draft, a 2-layer draft and prompt lookup (P, B4
     layers x rounds, D1 + D2), every token teacher-forced, self-draft
     acceptance >= 0.75; QA, B7, B8, B9 and B4 each launched on these
     paths. (4o, after 4l) Training at Phi-3-mini's widths
     (`phi3_mini_widths_config`, depth cut to 8 layers, printed) as 4h
     trains Llama, over B 2 x S 2040 (below its left-out window of 2047,
     checked): P, B13a and B13b at D 96 each once a layer and step (24 in
     3 steps) on path "phi3-widths training", the loss falling, first-step
     gradients within 0.05 of the plain route's, peak memory; then
     `flash_attention_varlen` at D 96 (32 / 32 heads) over 3g's packed
     batch, causal: B12 once (path "phi3-widths varlen"), held to its plain
     version within 3e-2. (4p, after 4m / 4n, on a tree of its own) A
     model at Llama-3.1-405B's widths (`llama31_405b_widths_config`:
     hidden 16384, 128 / 8 heads (a GQA group of 16), D 128, SwiGLU 53248,
     vocab 128256, untied, RoPE theta 500000 with llama3 scaling; depth cut
     from 126 to 4 layers, printed), random weights: as 4m, teacher-forced
     prefill and decode-step logits, greedy generation (B 4, prompt 512, 64
     new: P 4, D1 + D2 63 x 4), then as 4n greedy over an int8 cache (QA,
     B7 + D2), and serving runs A, B, D and E over the 24 requests (P or B6
     / B9 at admission, B5 / B8 + D2, the append / QA), every token
     teacher-forced; launches on paths "405b-widths ...", each run's exact,
     and the paged extends B6 and B9 launched on them. (4q, last)
     Sequence-parallel attention (parallel/sequence.py) at Llama-3.1-8B's
     attention widths (32 / 8 heads, D 128, bf16, B 1, random inputs): the
     ring over 8 ranks of 4096 tokens (S 32768) unrolled in one process,
     causal (zig-zag stripes) and non-causal, and the all-gather route,
     counted on path "sp" (B4-partials 8 x 9 + 8 x 8, B4 8, nothing else),
     each within 3e-2 of P over the whole sequence, the ring within 3e-2
     of the all-gather; at S 4096 over 4 ranks the ring causal, non-causal
     and at an odd S_local (S 4092: the three offsets) and the all-gather
     with a window of 1000 within 3e-2 of the fp32 plain dense reference;
     the public `ring_attention` (causal, non-causal) and
     `allgather_attention` over a one-rank NCCL `DeviceMesh` on cuda:0
     (path "sp nccl": B4-partials 3, B4 1) within 3e-2 of P; every one of
     these also row by row within ROW_TOL (`row_err`). (4r, after
     4q) Shallow models at head dims outside TMA's stride rule
     (`pitched_model_config`: Llama-3-8B's widths at head dim D, 2 layers
     or --layers): D 100 over bf16 caches and pages (rows of 104): as 4m,
     teacher-forced logits, greedy (B 4, prompt 512, 64 new) and serving
     runs A / B; D 40 over int8 and e4m3 caches and pages (rows of 48
     bytes): as 4n, greedy over int8 / e4m3 caches and serving runs D / E;
     each over the first 8 of the 24 requests, every token teacher-forced,
     launches exact on paths "pitched d100 ..." / "pitched d40 ...", no
     cache or pool copied (`_build.copies["cache"]` 0), the activations'
     padded copies printed.
     (4k, run after 4e over the Llama tree; launches counted as path "hf")
     The HF surface: (a) HF-named transposed views of the parameters
     through `params_from_state_dict`, then greedy generation: phase 4's
     tokens and launch counts exactly; (b) `interop.attention_forward` on a
     stand-in module (layer 0's projections as bf16 Linears, an HF-style
     config, a cache grown by torch.cat as HF's DynamicCache grows) at B 4
     x 512: an unpadded prefill (P), a right-padded prefill of lengths 512
     / 400 / 257 / 1 (B4), 8 decode steps (D1 + D2), then the same with a
     window of 256 (B2, windowed D1), each attention output within 3e-2 of
     the fp32 reference on the same q / k / v, and one torch.compile
     (inductor) of a call of the custom op, equal to the eager call; (c)
     where `transformers` imports (otherwise one line says why not): HF
     `LlamaForCausalLM` of these widths holding the same weights,
     `patch_llama()`, greedy generation of 32 tokens over HF's DynamicCache
     (P layers, D1 + D2 layers x 31) teacher-forced against the port's
     `forward` (logit limits below, argmax share >= 0.9), prefill ms,
     decode ms/token and host wall, and `sequence_classification_forward`
     with a random [hidden, 2] score head, kernel route vs plain route
     within 3e-2; the original `LlamaAttention.forward` restored.
  5. numbers: per-kernel times, bounds and library times as one JSON line
     (for D1 one SDPA call over the length-masked cache against D1 + D2
     together, "with_combine_ms"; for B7-B9 SDPA over a dequantized bf16
     copy, for
     B10 / B11 `x @ w` over a dequantized bf16 weight, the dequantization
     not timed, at every projection of the int8 and fused int4 trees at
     decode rows and T 2048 under "projections", timed over weight copies
     larger than the L2; for B4 one SDPA call over the contiguous cache with the
     causal-offset and length mask, at the verify shape and a chunk);
     prefill and decode times, also with quantized weights;
     serving wall time, tokens/s, TTFT, rounds, pool bytes and peak memory
     per run; speculative runs' wall time, tokens/s, rounds, acceptance
     share and ms per round beside greedy generation's; the bytes of each
     parameter tree; (5b) B2's row at Mistral-7B's greedy prefill (B 2,
     S 5120, W 4096; library_ms: SDPA with the window as a boolean mask)
     and, under "window", each of D1, B4, B5-B9 with W 4096 at a Mistral
     shape past the window; the Mistral / Qwen2 numbers ("families"); (5c)
     the rows of B13a and B13b at the training step's attention (B 2, S
     2048, causal; library_ms: SDPA's backward, forward + backward minus
     forward) and of B12 at 3g's packed batch (library_ms: SDPA over the
     padded batch), and the lse's cost on P and B2 (with and without it;
     at the training shape also its launches, bound, plain version and
     SDPA's forward); the B13a / B13b rows' "gemma2" entries at 4l's global
     layer (B 1, S 4608, 16 / 8 heads, D 256, causal; library_ms: SDPA's
     backward at D 256 with enable_gqa, or null with the reason where no
     backend of the card takes it) with the "B13a D256" / "B13b D256"
     runtime attributes;
     the training numbers ("training", and 4l's "training_gemma2"); phase 4k's numbers ("hf"); (5d) the "gemma2" entries of the P,
     B2, D1, D2, B7, B4, B5, B6, B8, B9, B12, QA and append rows at Gemma-2-9B
     shapes
     with the cap 50 (library_ms: `flex_attention` with a tanh score_mod for
     P / B2 where it compiles, else SDPA without the cap; SDPA without the
     cap for D1 + D2 / B4 / B5 / B6 / B8 / B9 / B12, over a dequantized copy
     for B8 / B9;
     labelled in each entry's shape); the rows of P / B2, B4, B5, B6, B8,
     B9, B12 and B13a / B13b carry the runtime's registers, spill and shared
     bytes of their instantiation ("runtime_attributes"); (5e) the rows of
     P-i8 (B 4 S 512; "long": B 1 S 8192; "gemma2": B 2 S 4608, D 256, cap
     50), B2-i8 (Mistral B 2 S 5120 W 4096) and K8 (the K of P-i8's row and
     of "long"): the kernel alone ("ms"), the wrapper's K8 + kernel
     ("with_k8_ms"), the bf16-score P / B2 on the same inputs ("bf16_ms"),
     bounds of QK^T at the int8 peak plus PV at the bf16 peak (or the
     bytes), library_ms null; (5f) the "phi3" entries of the P, D1, D2,
     B5, B6 and append rows at 4m's shapes (D 96; bounds at D 96;
     library_ms: SDPA at D 96, over a contiguous copy for B5 / B6); (5g)
     those of the B7, B8, B9, QA and B4 rows at 4n's shapes (B7 at the int8
     greedy path's middle decode step, B8 and QA at run D's decode, B9 at
     run E's extend, B4 at the last verify round and a chunk of 256;
     library_ms: SDPA at D 96 over a dequantized contiguous copy, none for
     QA); (5h) the "phi3" entries of the B13a / B13b rows at 4o's step (B
     2, S 2040, 32 / 32 heads, D 96; library_ms: SDPA's backward at D 96,
     fwd + bwd - fwd) and of the B12 row at 4o's packed batch (library_ms:
     SDPA over the padded batch), bounds at D 96, with the runtime report
     of the instantiation they run (B13a / B13b: D 128's padded ones);
     (5i) the "g16" entries of the P, D1, D2, B5, B6, append, B7, B8, B9
     and QA rows at 4p's shapes (Llama-3.1-405B's 128 / 8 heads; library_ms
     SDPA with the group expanded, over a contiguous or dequantized copy)
     and the "m71" entries of the D1, B5, B7 and B8 rows at Falcon-7B's 71
     / 1 heads, D 64, a decode of B 8 over 2048 keys a row (bounds: the
     visible K / V read once at 3.35 TB/s; library_ms one SDPA call over the
     cache with the group expanded); (5j) the row of B4's partials
     ("flash_chunked_partials") at a non-causal ring step of 4q's shape
     (4096 rows, 4096 keys) and, under "zigzag_step", at a zig-zag step
     (4096 rows, 2048 keys), library_ms null (no PyTorch call returns the
     partials), and under "sequence_parallel" the unrolled ring (causal,
     non-causal) and all-gather over 32768 tokens beside P and one SDPA
     call (causal) over the same; (5k) the "o" entries of every kernel row
     with a head dim at D 100 (two-byte rows, pitch 104; P, B2, D1, D2, B5,
     B6, the append, B4 and its partials, B12, B13a / B13b, P-i8, B2-i8,
     K8) or D 40 (one-byte rows, pitch 48 bytes; B7, B8, B9, QA), at 4r's
     widths, inputs at the port's pitch, each with "pitch_cost": the same
     kernel's ms at D 104 / 48, whose rows need no pitch; and the "phi3"
     entries of the P-i8, B2-i8 and K8 rows at 3o's int8-score path; (5l)
     head dims from 257 to 512, which P / B2 and B12 run in the wide layout
     of 512, at DeepSeek-V4-Flash's attention widths (64 / 1 heads, D 512,
     bf16; no model: JAX's API and model path refuse a head dim above 256,
     as the port's do): the entry points `flash_attention_fwd` and
     `flash_attention_varlen` on path "v4-widths" (P causal at B 1 x 8192
     with and without the lse, B2 with the config's window of 128 and with
     a cap of 50 too, B12 over 8 packed causal sequences of 517-4096
     tokens, 16384 in all; counted exactly: P 2, B2 2, B12 1), each output
     within 3e-2 of its fp32 plain version (8 q heads at a time), the lse
     within 1e-3 with the same +inf rows, a second call bit for bit; d 260
     (rows of 264), 320 and 384 alike at B 1 x 2048 and a packed batch of
     4096 tokens; then the "v4" entries of the P, B2 and B12 rows (ms,
     plain, bound, SDPA's time over k / v expanded to the q heads with the
     backend torch picks there, P's time with its lse, B2's with the cap,
     the D 512 instantiation's runtime attributes); (5m) head dims from 257
     to 512 in B4 (with its (o, m, l) partials) and B6, which run them in
     the same wide layout, and sequence-parallel attention, at the same
     widths with the config's window of 128, on path "v4-extend" through
     `flash_attention_chunked` (B 1 over a cache of 8192 keys: a chunk of
     1024 rows at q_offset 7168, causal and windowed, a verify round of 5
     rows, the partials of both), `paged_attention_extend` (B 4 chunks of
     512 rows at offsets 0-3584, pages of 16 and 64 behind a shuffled
     table, NaN past every length, once windowed) and the ring (causal
     zig-zag, non-causal) and all-gather (windowed) unrolled over 8 ranks
     at 16384 tokens as in 4q, counted exactly (path "v4-extend": B4 3,
     B4-partials 2, B6 3; path "v4-extend sp": B4 8, B4-partials 72 + 64;
     nothing else): each kernel output within 3e-2 of its fp32 plain
     version (8 q heads at a time; the partials by `partials_err`) and row
     by row within ROW_TOL (`row_err`), repeated bit for bit; ROW_TOL's
     reach (B4's chunk against its plain version over a V tile of 32 keys
     zeroed and with one key past the diagonal: row_err above ROW_TOL); a
     wholly-future chunk's partials m = l = o = 0; the ring and all-gather
     within 3e-2 and ROW_TOL of P / B2 over the whole sequence and of the
     fp32 plain reference at 2048 tokens, the entry points over a one-rank
     NCCL mesh at 4096 (path "v4-extend nccl": B4-partials 3, B4 1)
     against P / B2; d 260 (rows of 264), 320 and 384 alike at a small
     size; then the "v4" entries of the B4, B4-partials and B6 rows (ms,
     plain, bound, SDPA with the visibility as a boolean mask over k / v
     expanded to the 64 q heads, B6's over a gathered copy, null for the
     partials; the verify round, the window and pages of 64 beside them;
     the unrolled ring beside P and one SDPA call over the 16384 tokens);
     (5n) head dims from 257 to 512 in the decodes D1, B5, B7 and B8 (the
     wide layout of paged_decode.cuh: each consumer warp owns 256 of O's
     columns, 16-key tiles) with D2, the append and QA, and in B9 (B6's
     wide layout), at the same widths, on path "v4-decode": B 4 rows admit
     prompts of 4096, 2900, 1537 and 517 tokens one row at a time (the
     append then B6 over bf16 pages, QA then B9 over int8 and e4m3 pages;
     pages of 16 and 64 behind shuffled tables, NaN everywhere before) and
     run 32 decode steps (each row's new K / V through the append or QA,
     then B5 or B8 and D2, plainly and with the window of 128 over pages of
     16 or the cap 50 over pages of 64), and over contiguous caches [1, 4,
     1, 8192, 512] (bf16, int8, e4m3; NaN past the lengths) the same steps
     through D1 or B7 and D2 (the window and the cap together), the new
     K / V written by indexing (bf16, as the model does) or QA; counted
     exactly (append 72, B6 8, B5 128, QA 208, B9 16, B8 256, D1 64, B7
     128, D2 576; nothing else); every output within 3e-2 of its fp32
     plain version (B6 / B9 8 q heads at a time) and, row by row, within
     ROW_TOL, repeated bit for bit after the path (the pools then hold the
     later rows past each call's lengths), the appends and QA replayed by
     their plain versions on copies of the pools giving the same bytes; D2
     alone on D1's partials; d 260 (rows of 264) and 320 alike at a small
     size, each kernel launched; then the "v4" entries of the D1, D2, B5,
     B7, B8, B9, append and QA rows (ms, plain, bound, SDPA over a
     contiguous, gathered or dequantized copy with the group expanded,
     `index_copy_` for the append; pages of 64, the window, e4m3 beside
     them; the D 512 instantiations' runtime attributes); (5o) head dims
     from 257 to 512 in the backward B13a / B13b (the layout of 512 of
     csrc/flash_bwd.cu: B13a two blocks a 64-key block, 256 of dK's and
     dV's columns each, over 32-row q tiles; B13b 16-key tiles, its
     consumers splitting the depth of S and dP), at the same widths:
     gradients through `ops.autodiff.flash_attention` at B 1 x 4096,
     causal and with the window of 128, within 2e-2 of each gradient's
     largest value of the fp32 plain backward (fed the kernel forward's o
     and lse, 8 q heads at a time) and, row by row, ROW_TOL, repeated bit
     for bit; three AdamW steps over leaf q, k, v against a fixed random
     target, causal and windowed, on path "v4-train" (counted exactly:
     causal P 3, B13a 3, B13b 3; windowed B2 3, B13a 3, B13b 3; nothing
     else), the loss falling; d 260 (rows of 264) and 320 alike at B 1 x
     256, 8 / 1 heads; D 520 and D 0 refused by the backward and the
     autograd op before any launch; then the "v4" entries of the B13a and
     B13b rows (ms, plain, the operations bound, SDPA's backward or null
     with its reason, the D 512 instantiations' runtime attributes); every
     timed entry its share of its bound ("of_bound"); the card's name and
     power limit.
The last line is {"ok": true, "device": {...}}.

Tolerances: kernel outputs are bf16 results of fp32 arithmetic on bf16
inputs, held against the fp32 plain version at max |diff| <= 3e-2 (the
repository's bf16 figure); the quantized kernels too (their int8 / e4m3
values widen to bf16 exactly, P is rounded to bf16 before PV as in B6,
and B5 / B6 / B7 / B8 / B9 and D1 repeat bit for bit; D1 takes P in two
bf16 parts, so its partials are held to the plain fp32 sums at 1e-2), and
B10 / B11 (x at unit scale, weights of std fan_in ** -0.5, fp32 sums).
P-i8 / B2-i8 compute the same fp32 scores as their plain int8 version (the
same quantization, exact integer products), so they are held to its fp32
output at 3e-2 as well; int8 scores against bf16 ones move the output by
up to 5e-2 (the JAX package's envelope of int8 scores). Teacher-forced logits of the kernel path and the plain-attention path, and
of a quantized tree and its dequantized image: max |diff| <= 1.0 and mean
|diff| <= 0.1. The logits have std about 1 with these weights, so a wrong kernel moves them by
O(1) on average; the two paths differ only by bf16 roundings (P rounded
to bf16 before PV) compounded over 32 layers, which stay an order of
magnitude below that (0.008 mean at 2 layers on an H100). The same limits
hold the serving forward (`forward_paged`: prefill, extend, decode) on the
kernel route against its plain_attention route. Serving tokens come from
bf16 kernels and are held against one contiguous teacher-forced prefill:
each within 1.0 of the top logit, and at least 0.9 of them its argmax (an
H100 gave 0.97 at 32 layers and 0.99 at 2: with 128k logits of std 1, an
error of a few tenths reorders the top and lowers the share). Long-context
outputs (3k / 3o at D 264, 4q, 5m) are also held row by row: max |diff|
over the row's largest |value| <= ROW_TOL = 2e-2 (`row_err`), since a row
over n unit-normal keys has values of about sqrt(e / n), far below 3e-2.

Kernel times ("ms") are device times from CUDA events with the host's
launch overhead hidden; "call_ms" is the time per call of back-to-back
calls, host overhead included (utils/timing.py).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 3e-2
# Phases 3k / 3o (D 264), 4q and 5m also hold each row of an output at its
# own scale (`row_err`: max |diff| over the row's largest |value|). A row
# that sees n unit-normal keys has values of about sqrt(e / n), 0.019 at
# 7169 keys, so BF16_TOL alone cannot see a key tile dropped or a key
# unmasked there; bf16 rounding stays near 2^-8 of the row's scale, and two
# bf16 outputs of one attention differ by at most two ulps, 2^-6 of it.
# Phase 5m measures the reach of the limit ("reach" in its output).
ROW_TOL = 2e-2
LOGIT_MAX_TOL, LOGIT_MEAN_TOL = 1.0, 0.1
ARGMAX_SHARE_MIN = 0.9
# D1 computes split partials, which no PyTorch call does: its row's
# library_ms is one SDPA call over the cache against D1 + D2 together
# (`with_combine_ms`), as B7's and B5 / B8's rows include D2.
LIBRARY_OF_D1 = ("D1 + D2 (with_combine_ms) against one SDPA call over the length-masked "
                 "cache (the window too where the entry has one), GQA expanded")
# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
B, PROMPT, NEW, CAPACITY = 4, 512, 64, 576


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_err(a, b) -> float:
    """The largest over the rows (the last axis) of max |a - b| over the
    row's max |b|: each row's error at its own scale (a row of b that is all
    zero must be matched exactly)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1e-30)).max().item()


def partials_row_err(got, want) -> float:
    """`row_err` of B4's (o, m, l) partials: o's rows at their own scale, l
    relative to l' (a row of l' = 0 must give 0), and |m - m'|."""
    (o, m, l), (o_p, m_p, l_p) = got, want
    return max(row_err(o, o_p), ((l - l_p).abs() / l_p.clamp(min=1e-30)).max().item(),
               (m - m_p).abs().max().item())


# Phase 3: (name, batch, hq, hkv, sq, skv, causal, window, dtype, transposed)
# of P / B2 at Llama widths (D 128) against the fp32 plain version: the
# main path's shape, the edges of the kernel's 128-row blocks and 128-key
# tiles, rows with no key, GQA groups 1, 7 (Qwen2) and 32, f16, non-causal,
# windows of 1, 45 and 400 keys, the model's transposed views.
def pitched(torch, x):
    """`x` copied into rows at `_build.row_pitch` (views of its head dim, as
    the port's caches, pools and outputs lie), or `x` itself where its head
    dim needs no pitch."""
    from flash_attention_cute_tpu_torch.ops import _build

    d = x.shape[-1]
    if _build.row_pitch(d, x.element_size()) == d:
        return x
    return _build.empty_rows(x.shape, x.dtype, x.device).copy_(x)


PREFILL_CASES = (
    ("B4 S512 main path", 4, 32, 8, 512, 512, True, None, "bfloat16", False),
    ("B2 S1024 causal", 2, 32, 8, 1024, 1024, True, None, "bfloat16", False),
    ("S1", 2, 32, 8, 1, 1, True, None, "bfloat16", False),
    ("S63", 1, 32, 8, 63, 63, True, None, "bfloat16", False),
    ("S65", 1, 32, 8, 65, 65, True, None, "bfloat16", True),
    ("S130", 1, 32, 8, 130, 130, True, None, "bfloat16", True),
    ("S1000 ragged", 1, 32, 8, 1000, 1000, True, None, "bfloat16", True),
    ("Sq256 Skv1024 offset", 1, 32, 8, 256, 1024, True, None, "bfloat16", False),
    ("Sq64 Skv1000", 1, 32, 8, 64, 1000, True, None, "bfloat16", False),
    ("Sq1024 Skv256 zero rows", 1, 32, 8, 1024, 256, True, None, "bfloat16", False),
    ("Sq1000 Skv64 zero rows", 1, 32, 8, 1000, 64, True, None, "bfloat16", True),
    ("group 1", 1, 8, 8, 300, 300, True, None, "bfloat16", False),
    ("Qwen2 group 7", 2, 28, 4, 700, 700, True, None, "bfloat16", True),
    ("MQA group 32", 1, 32, 1, 1000, 1000, True, None, "bfloat16", False),
    ("f16", 1, 32, 8, 333, 333, True, None, "float16", True),
    ("non-causal Sq300 Skv1000", 1, 32, 8, 300, 1000, False, None, "bfloat16", False),
    ("window 1", 1, 32, 8, 1000, 1000, True, 1, "bfloat16", True),
    ("window 45", 1, 32, 8, 1000, 1000, True, 45, "bfloat16", True),
    ("window 400", 1, 32, 8, 1000, 1000, True, 400, "bfloat16", True),
)


def held_prefill(torch, flash_fwd, errs, what, q, k, v, causal, window, cap=None, tag=None,
                 step=0):
    """One P / B2 call with its lse against the fp32 plain version run on q's
    fp32 image (`step` q heads at a time where `step`, `by_kv_head`): output within
    BF16_TOL and finite, lse within LSE_TOL on finite entries with the same
    +inf rows, rows with no key exact zeros; a second call (with and without
    the lse) repeats the bits. Errors go to the kernel's entries of `errs`
    (also "<kernel> <tag>" with a `tag`)."""
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    again, lse_again = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    bare = flash_fwd.flash_attention_fwd(q, k, v, **kw)
    same = torch.equal(out, again) and torch.equal(lse, lse_again) and torch.equal(out, bare)
    del again, lse_again, bare

    def plain(q_, k_, v_):
        return flash_fwd.flash_attention_fwd_plain(q_.float(), k_.float(), v_.float(),
                                                   return_lse=True, **kw)

    ref, ref_lse = by_kv_head(torch, plain, q, k, v, step) if step else plain(q, k, v)
    e = max_err(out, ref)
    fin = torch.isfinite(ref_lse)
    e_lse = (lse[fin] - ref_lse[fin]).abs().max().item() if bool(fin.any()) else 0.0
    name = "flash_fwd_window" if window and window < k.shape[2] else "flash_fwd"
    for key in (name, f"{name} {tag}") if tag else (name,):
        errs[key] = max(errs.get(key, 0.0), e)
        errs[f"{key} lse"] = max(errs.get(f"{key} lse", 0.0), e_lse)
    print(f"  {what}: max|diff| {e:.3e}, lse {e_lse:.2e}, repeated bit for bit: {same}")
    check(bool(torch.isfinite(out).all()), f"{what}: finite")
    check(e <= BF16_TOL, f"{what} within {BF16_TOL}")
    check(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)), f"{what}: lse +inf pattern")
    check(e_lse <= LSE_TOL, f"{what}: lse within {LSE_TOL}")
    check(same, f"{what}: a second call repeats output and lse bit for bit")
    sq, skv = q.shape[2], k.shape[2]
    if causal and sq > skv:
        dead = slice(0, sq - skv)
        check(bool((out[:, :, dead] == 0).all()) and bool(torch.isinf(lse[:, :, dead]).all()),
              f"{what}: rows with no key are exact zeros with lse +inf")
    return out


def phase_kernels(torch, flash_fwd, flash_decode, errs):
    """P / B2 (PREFILL_CASES, with the lse), D1, D2 against their plain
    versions (Hq 32, Hkv 8, D 128, bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for name, b, hq, hkv, sq, skv, causal, w, dt, transposed in PREFILL_CASES:
        dtype = getattr(torch, dt)
        if transposed:  # the model's [B, S, H, D] projections
            q = randn(b, sq, hq, 128, dtype=dtype).transpose(1, 2)
            k, v = (randn(b, skv, hkv, 128, dtype=dtype).transpose(1, 2) for _ in "kv")
        else:
            q = randn(b, hq, sq, 128, dtype=dtype)
            k, v = randn(b, hkv, skv, 128, dtype=dtype), randn(b, hkv, skv, 128, dtype=dtype)
        held_prefill(torch, flash_fwd, errs, f"{'B2' if w else 'P'} {name} ({hq} / {hkv} heads, "
                     f"{dt}{', transposed views' if transposed else ''})", q, k, v, causal, w)
        del q, k, v

    lens = [576, 513, 37, 0]
    kc, vc = randn(4, 4, 8, 576, 128), randn(4, 4, 8, 576, 128)
    for i, n in enumerate(lens):  # uninitialised cache tail
        kc[:, i, :, n:] = float("nan")
        vc[:, i, :, n:] = float("nan")
    q = randn(4, 32, 1, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5
    for splits in (5, 2):
        acc, m, l = flash_decode.decode_partials(q, kc[2], vc[2], lengths, scale, splits)
        ref = flash_decode.decode_partials_plain(q, kc[2], vc[2], lengths, scale, splits)
        e1 = max(max_err(x, y) for x, y in zip((acc, m, l), ref))
        o = flash_decode.decode_combine(acc, m, l, torch.bfloat16)
        e2 = max_err(o, flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16))
        out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths,
                                                  num_splits=splits, layer=2)
        e12 = max_err(out, flash_decode.flash_attention_decode_plain(
            q, kc, vc, kv_length=lengths, num_splits=splits, layer=2))
        errs["decode_partials"] = max(errs.get("decode_partials", 0.0), e1)
        errs["decode_combine"] = max(errs.get("decode_combine", 0.0), e2)
        print(f"  D1 splits {splits}: partials max|diff| {e1:.3e}; D2 {e2:.3e}; "
              f"D1+D2 vs fp32 plain {e12:.3e}")
        check(e1 <= 1e-2, "D1 partials (fp32 sums of the same inputs) within 1e-2")
        check(e2 <= BF16_TOL and e12 <= BF16_TOL, f"D2 and D1+D2 within {BF16_TOL}")
        check(bool(torch.isfinite(out).all()), "decode output finite over a NaN tail")
        check(bool((out[3] == 0).all()), "decode row of length 0 is 0")
    held_contiguous_decodes(torch, flash_decode, None, errs, gen, CONTIG_DECODE_CASES["llama"],
                            (None,))


# Edges of the contiguous decodes D1 and B7, which run B5 / B8's kernel
# (name, head dim, q heads, kv heads, capacity, window, soft cap, q's
# dtype): head dims 64 / 128 / 256, GQA groups 1-32, capacities that are no
# multiple of 4 nor of a tile (B7's scale rows off every 16-byte boundary),
# windows, the caps, f16. Each case runs over a stacked [2, B, Hkv, C, D]
# cache through `layer`, rows of lengths 0, 1, 37, C - 1, C and C / 2 + 3,
# NaN at and past every length.
CONTIG_DECODE_CASES = {
    "llama": (("D 128 group 4 capacity 577", 128, 32, 8, 577, None, None, "bfloat16"),
              ("D 64 group 1 capacity 1030", 64, 8, 8, 1030, None, None, "bfloat16"),
              ("D 128 group 2 capacity 130 f16", 128, 16, 8, 130, None, None, "float16"),
              ("D 64 group 16 capacity 999", 64, 32, 2, 999, None, None, "bfloat16"),
              ("D 128 group 32 capacity 2051", 128, 32, 1, 2051, None, None, "bfloat16")),
    "window": (("window 45 group 8 capacity 5153", 128, 32, 4, 5153, 45, None, "bfloat16"),
               ("window 4096 group 7 capacity 5153", 128, 28, 4, 5153, 4096, None, "bfloat16"),
               ("window 1 D 64 group 16 capacity 1031", 64, 32, 2, 1031, 1, None, "bfloat16")),
    "gemma2": (("D 256 group 2 cap 50 capacity 4641", 256, 16, 8, 4641, None, 50.0, "bfloat16"),
               ("D 256 group 2 cap 1.0 window 4096 capacity 4641", 256, 16, 8, 4641, 4096, 1.0,
                "bfloat16"),
               ("D 256 group 16 cap 50 capacity 1027 f16", 256, 16, 1, 1027, None, 50.0,
                "float16"),
               ("D 256 group 32 cap 1.0 capacity 770", 256, 32, 1, 770, None, 1.0, "bfloat16"),
               ("D 128 group 4 cap 50 capacity 577", 128, 32, 8, 577, None, 50.0, "bfloat16")),
}


def held_contiguous_decodes(torch, flash_decode, quantized, errs, gen, cases,
                            values=(None, "int8", "float8_e4m3fn"), tag=None):
    """D1 + D2 (`values` None: a cache in q's dtype) and B7 + D2 (int8 and
    e4m3 caches, NaN in the scales and e4m3 values past the lengths) on each
    case of `cases`
    against their fp32 plain versions run on q's fp32 image; a length-0 row
    of exact zeros, a second call bit-identical to the first. D1 + D2's
    errors go to "decode_combine", B7's to "quant_decode" (at D 256 also
    "quant_decode gemma2"); with a `tag` also to "<key> <tag>"."""
    for name, d, hq, hkv, cap_len, w, cap, dt in cases:
        dtype = getattr(torch, dt)
        lens = [0, 1, 37, cap_len - 1, cap_len, cap_len // 2 + 3]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dead = torch.arange(cap_len, device="cuda")[None, :] >= lengths[:, None]
        dead = dead[None, :, None, :].expand(2, -1, hkv, -1)
        q = torch.randn((len(lens), hq, 1, d), generator=gen, device="cuda").to(dtype)
        for vname in values:
            caches = []
            for _ in "kv":
                x = torch.randn((2, len(lens), hkv, cap_len, d), generator=gen, device="cuda")
                if vname is None:
                    x = x.to(dtype)
                    x[dead] = float("nan")
                    x = pitched(torch, x)
                else:
                    x = quantized.quantize_kv(x, getattr(torch, vname))
                    poison_quant(torch, x, dead)
                    x = type(x)(pitched(torch, x.values), x.scales)
                caches.append(x)
            if vname is None:
                key, what = "decode_combine", f"D1 + D2 {name}"
                fn = flash_decode.flash_attention_decode
                plain = flash_decode.flash_attention_decode_plain
            else:
                key, what = "quant_decode", f"B7 + D2 {vname} {name}"
                fn = quantized.flash_attention_decode_quantized
                plain = quantized.flash_attention_decode_quantized_plain
            kw = dict(window=w, logit_softcap=cap, layer=1)
            out, again = fn(q, *caches, lengths, **kw), fn(q, *caches, lengths, **kw)
            e = max_err(out, plain(q.float(), *caches, lengths, **kw))
            keys = [key] + ([f"{key} gemma2"] if vname is not None and d == 256 else [])
            for k in keys + ([f"{key} {tag}"] if tag else []):
                errs[k] = max(errs.get(k, 0.0), e)
            print(f"  {what}, lengths {lens}: max|diff| {e:.3e}")
            check(bool(torch.isfinite(out).all()), f"{what}: output finite over NaN tails")
            check(bool((out[0] == 0).all()), f"{what}: row of length 0 is exactly 0")
            check(torch.equal(out, again), f"{what}: a second call repeats the first bit for bit")
            check(e <= BF16_TOL, f"{what} within {BF16_TOL}")
            del caches
        torch.cuda.empty_cache()


# Phase 3d: (name, dtype, S, capacity, q_offset, kv_length (None:
# q_offset + S), head_dim, causal, (q heads, kv heads), window, soft cap) of
# kernel B4 against its plain version: Llama-3-8B widths, then the soft cap
# and D 256 at Gemma-2-9B's (16 / 8), with its window of 4096, and the GQA
# packing at Qwen2-7B's group of 7 (S 5: 7 heads a block; S 20: one).
CHUNKED_CASES = (
    ("verify B4 S5", "bfloat16", 5, 640, [0, 130, 511, 600], None, 128, True, (32, 8), None,
     None),
    ("chunk S256", "bfloat16", 256, 1100, [0, 77, 300, 768], None, 128, True, (32, 8), None,
     None),
    ("kv_length 0 row", "bfloat16", 64, 640, [10, 0, 300, 500], [74, 0, 364, 564], 128, True,
     (32, 8), None, None),
    ("non-causal", "bfloat16", 100, 640, [0, 50, 300, 520], [100, 200, 450, 620], 128, False,
     (32, 8), None, None),
    ("D 64", "bfloat16", 70, 640, [0, 33, 263, 569], None, 64, True, (32, 8), None, None),
    ("verify B4 S5 f16", "float16", 5, 640, [0, 130, 511, 600], None, 128, True, (32, 8), None,
     None),
    ("chunk S256 f16", "float16", 256, 1100, [0, 77, 300, 768], None, 128, True, (32, 8), None,
     None),
    ("D 64 cap 30, window 100", "bfloat16", 70, 640, [0, 33, 263, 569], None, 64, True,
     (32, 8), 100, 30.0),
    ("Gemma verify S5 D 256 cap 50", "bfloat16", 5, 4640, [4600, 0, 2000, 13],
     [4605, 0, 2005, 18], 256, True, (16, 8), None, 50.0),
    ("Gemma verify S5 D 256 cap 50 window 4096 f16", "float16", 5, 4640, [4600, 0, 2000, 13],
     [4605, 0, 2005, 18], 256, True, (16, 8), 4096, 50.0),
    ("Gemma chunk S256 D 256 cap 1.0 window 4096", "bfloat16", 256, 4640, [4096, 300, 0, 4352],
     None, 256, True, (16, 8), 4096, 1.0),
    ("Gemma chunk S300 D 256 cap 50, non-causal", "bfloat16", 300, 4640, [0, 0, 500, 4000],
     [300, 0, 4340, 4340], 256, False, (16, 8), None, 50.0),
    ("Qwen2 group 7 verify S5 (7 heads a block)", "bfloat16", 5, 640, [0, 130, 511, 600], None,
     128, True, (28, 4), None, None),
    ("Qwen2 group 7 S20 cap 50 (one head a block)", "bfloat16", 20, 640, [0, 130, 500, 600],
     None, 128, True, (28, 4), None, 50.0),
)


def chunked_inputs(torch, gen, dtype, s, cap, offs, kvl, d, hq=32, hkv=8):
    """B4's inputs as the model hands them in: q/k/v transposed views of
    [B, S, H, D] buffers, K/V NaN at and past every row's kv_length."""
    kvl = [o + s for o in offs] if kvl is None else kvl

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b = len(offs)
    q = pitched(torch, randn(b, s, hq, d)).transpose(1, 2)
    k, v = (pitched(torch, randn(b, cap, hkv, d)).transpose(1, 2) for _ in "kv")
    for i, n in enumerate(kvl):  # uninitialised cache tail
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    rows = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (offs, kvl))
    return q, k, v, *rows


def phase_chunked_kernels(torch, flash_chunked, errs):
    """B4 against its fp32 plain version (run on q's fp32 image) over
    CHUNKED_CASES, bf16 and f16, over NaN-poisoned caches and transposed
    views: the verify shape, a chunk, a kv_length-0 row, non-causal, D 64,
    the soft caps 30 / 50 / 1.0, D 256 and windows at Gemma-2-9B's widths,
    Qwen2-7B's group of 7; every call repeated bit for bit. Errors at D 256
    also go to the "flash_chunked gemma2" entry of `errs`."""
    gen = torch.Generator(device="cuda").manual_seed(5151)
    for name, dtype, s, cap, offs, kvl, d, causal, (hq, hkv), w, sc in CHUNKED_CASES:
        q, k, v, off, lens = chunked_inputs(torch, gen, getattr(torch, dtype), s, cap, offs,
                                            kvl, d, hq, hkv)
        kw = dict(causal=causal, window=w, logit_softcap=sc)
        out = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
        again = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
        ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, lens, **kw)
        e = max_err(out, ref)
        for key in ("flash_chunked", "flash_chunked gemma2") if d == 256 else ("flash_chunked",):
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"  B4 {name} (q_offset {offs}, capacity {cap}): max|diff| {e:.3e}")
        check(e <= BF16_TOL, f"B4 {name} within {BF16_TOL}")
        check(bool(torch.isfinite(out).all()), f"B4 {name} finite over a NaN tail")
        check(torch.equal(out, again), f"B4 {name} repeats bit for bit")
        for i, n in enumerate(lens.tolist()):
            if n == 0:
                check(bool((out[i] == 0).all()), f"B4 {name}: a kv_length-0 row is 0")


def flat_pool(x):
    """One layer's pool [Hkv, P, ps, d] as [Hkv, P * ps, d] sharing its
    storage, whatever its row pitch (no `view`: a pitched pool has none)."""
    hkv, p, ps, d = x.shape
    return x.as_strided((hkv, p * ps, d), (x.stride(0), x.stride(2), 1), x.storage_offset())


def paged_pool(torch, randn, gen, ps, rows, capacity=2048, layers=2, d=128, hkv=8):
    """A stacked pool [layers, hkv, P, ps, d] (randn's dtype, rows at the
    port's pitch) with room for `rows` rows of `capacity` tokens, and a page
    table from a seeded permutation of its pages (page 0 in no table)."""
    pps = capacity // ps
    num_pages = rows * pps + 1
    kp = pitched(torch, randn(layers, hkv, num_pages, ps, d))
    vp = pitched(torch, randn(layers, hkv, num_pages, ps, d))
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: rows * pps].view(rows, pps).to(torch.int32).contiguous()
    return kp, vp, table


def poison_past(torch, pool, table, lengths):
    """NaN into every pool row at or past each row's length, and page 0."""
    ps, pps = pool.shape[3], table.shape[1]
    pos = torch.arange(pps * ps, device="cuda")
    for b, n in enumerate(lengths.tolist()):
        dead = pos[pos >= n]
        pool[:, :, table[b].long()[dead // ps], dead % ps] = float("nan")  # no flat view: pitched
    pool[:, :, 0] = float("nan")


# Phases 3 / 3b: (name, page_size, head_dim, hq, hkv, S, q_offset of rows
# 0-2, window, dtype) of the paged extends B6 and B9 against their fp32 plain
# versions: run B's chunk, page sizes 8, 16 and 128, head dims 64, 128 and
# 256, chunks of 1, 63, 65, 130 and 512 rows across the kernels' 128-row
# blocks and 128- / 64-key tiles, offsets off every tile and page boundary,
# windows of 1, 45 and 4096 keys, GQA groups 1, 7 and 8, f16. Row 3 of each
# is inactive (kv_length 0, exact zeros); pools are NaN at and past every
# length behind permuted tables; every call is repeated bit for bit.
EXTEND_CASES = (
    ("run B's chunk", 16, 128, 32, 8, 256, [0, 256, 1000], None, "bfloat16"),
    ("S 100, page_size 128", 128, 128, 32, 8, 100, [0, 256, 1000], None, "bfloat16"),
    ("S 63, page_size 8", 8, 128, 32, 8, 63, [5, 130, 1001], None, "bfloat16"),
    ("S 65, page_size 128, f16", 128, 128, 32, 8, 65, [127, 300, 77], None, "float16"),
    ("D 64, S 130, group 1", 16, 64, 8, 8, 130, [0, 61, 999], None, "bfloat16"),
    ("D 256, S 512", 16, 256, 16, 8, 512, [0, 512, 1003], None, "bfloat16"),
    ("D 256, S 1, page_size 128", 128, 256, 16, 8, 1, [0, 37, 3000], None, "bfloat16"),
    ("S 1, group 7", 16, 128, 28, 4, 1, [0, 37, 1500], None, "bfloat16"),
    ("window 1, S 130", 16, 128, 32, 8, 130, [0, 200, 1000], 1, "bfloat16"),
    ("window 45, S 65, page_size 8", 8, 128, 32, 8, 65, [10, 90, 2000], 45, "bfloat16"),
    ("window 4096, S 512", 16, 128, 32, 8, 512, [3584, 4096, 100], 4096, "bfloat16"),
    ("group 8, S 130, f16", 16, 128, 8, 1, 130, [3, 700, 1999], None, "float16"),
)


def held_extends(torch, errs, name, fn, plain, pools, tag):
    """Every EXTEND_CASES case of one paged extend (`fn` and `plain` take q,
    the case's pools, offsets, lengths, table and window) held to its fp32
    plain version; `pools(i, ps, d, hkv, lengths, dtype)` makes case i's
    NaN-poisoned pools and a permuted table for 4 rows of 5120 keys."""
    gen = torch.Generator(device="cuda").manual_seed(4322)
    for i, (what, ps, d, hq, hkv, s, offs, w, dname) in enumerate(EXTEND_CASES):
        dtype = getattr(torch, dname)
        off = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
        kvl = torch.tensor([o + s for o in offs] + [0], dtype=torch.int32, device="cuda")
        kp, vp, table = pools(i, ps, d, hkv, kvl.tolist(), dtype)
        q = torch.randn(4, s, hq, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        out = fn(q, kp, vp, off, kvl, table, w)
        again = fn(q, kp, vp, off, kvl, table, w)
        ref = plain(q.float(), kp, vp, off, kvl, table, w)
        e = max_err(out, ref)
        errs[name] = max(errs.get(name, 0.0), e)
        label = f"{tag} {what}, q_offset {offs}, window {w}"
        print(f"  {label}: max|diff| {e:.3e}")
        check(bool(torch.isfinite(out).all()), f"{label}: finite over NaN-poisoned pages")
        check(bool((out[3] == 0).all()), f"{label}: inactive row is exactly 0")
        check(torch.equal(out, again), f"{label}: a second call repeats bit for bit")
        check(e <= BF16_TOL, f"{label} within {BF16_TOL}")
        del kp, vp


def phase_paged_kernels(torch, paged_attention, paged_cache, errs):
    """B5, B6 and the paged append against their plain versions (Hq 32,
    Hkv 8, D 128, bf16; B6 over EXTEND_CASES), over NaN-poisoned pools and
    permuted tables."""
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def pools(_, ps, d, hkv, lengths, dtype):
        kp, vp, table = paged_pool(torch, lambda *sh: randn(*sh).to(dtype), gen, ps, rows=4,
                                   capacity=5120, layers=1, d=d, hkv=hkv)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        poison_past(torch, kp, table, lens)
        poison_past(torch, vp, table, lens)
        return kp[0], vp[0], table

    held_extends(
        torch, errs, "paged_extend",
        lambda q, k, v, off, kvl, t, w: paged_attention.paged_attention_extend(
            q, k, v, off, kvl, t, window=w),
        lambda q, k, v, off, kvl, t, w: paged_attention.paged_attention_extend_plain(
            q, k, v, off, kvl, t, window=w),
        pools, "B6")

    for ps in (16, 128):
        kp, vp, table = paged_pool(torch, randn, gen, ps, rows=8)
        full = table.shape[1] * ps
        lens = torch.tensor([0, 1, ps - 1, ps, ps + 1, full, 777, 2 * ps + 1],
                            dtype=torch.int32, device="cuda")
        poison_past(torch, kp, table, lens)
        poison_past(torch, vp, table, lens)
        q = randn(8, 32, 1, 128)
        out = paged_attention.paged_attention_decode(q, kp[1], vp[1], lens, table)
        ref = paged_attention.paged_attention_decode_plain(q, kp[1], vp[1], lens, table)
        e = max_err(out, ref)
        errs["paged_decode"] = max(errs.get("paged_decode", 0.0), e)
        print(f"  B5 page_size {ps}, lengths {lens.tolist()}: max|diff| {e:.3e}")
        check(bool(torch.isfinite(out).all()), "B5 output finite over NaN-poisoned pages")
        check(bool((out[0] == 0).all()), "B5 row of length 0 is exactly 0")
        check(e <= BF16_TOL, f"B5 page_size {ps} within {BF16_TOL}")

        # Append: decode rows (one inactive, one past the table) and a
        # 100-token chunk crossing pages; the kernel must write exactly
        # what the plain masked scatter writes.
        for s, starts, act in ((1, [0, 5, ps - 1, full, 37, 2 * ps, 1, 9], [1, 1, 1, 1, 0, 1, 1, 1]),
                               (100, [0, ps - 3, full - 40, 3], [1, 1, 1, 0])):
            b = len(starts)
            kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b)
            new_k, new_v = randn(b, s, 8, 128).transpose(1, 2), randn(b, s, 8, 128).transpose(1, 2)
            lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
            active = torch.tensor(act, dtype=torch.bool, device="cuda")
            ref_k, ref_v = kp[1].clone(), vp[1].clone()
            paged_cache.paged_append_layer(kp[1], vp[1], new_k, new_v, table, lengths, active)
            paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
            same = torch.equal(kp[1], ref_k) and torch.equal(vp[1], ref_v)
            errs["paged_append"] = max(errs.get("paged_append", 0.0),
                                       max_err(kp[1], ref_k), max_err(vp[1], ref_v))
            print(f"  append page_size {ps}, S {s}, starts {starts}: identical to plain: {same}")
            check(same, "append kernel writes exactly what the plain scatter writes")


QUANT_DTYPES = ("int8", "float8_e4m3fn")


def poison_quant(torch, kv, dead):
    """NaN into the scales where `dead` is True, and the e4m3 NaN byte 0x7F
    into the values there (int8 has no NaN)."""
    kv.scales[dead] = float("nan")
    if kv.values.dtype == torch.float8_e4m3fn:
        kv.values.view(torch.uint8)[dead] = 0x7F


def quant_pool(torch, quantized, randn, gen, ps, rows, dtype, lengths=None, capacity=2048, d=128,
               hkv=8):
    """One layer's quantized pools [hkv, P, ps, d] (values at the port's
    pitch) behind a seeded permuted table (page 0 in no table); with
    `lengths`, NaN-poisoned at and past each row's length and in page 0."""
    pps = capacity // ps
    num_pages = rows * pps + 1
    k, v = (quantized.quantize_kv(randn(hkv, num_pages, ps, d), dtype) for _ in "kv")
    k, v = (type(x)(pitched(torch, x.values), x.scales) for x in (k, v))
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: rows * pps].view(rows, pps).to(torch.int32).contiguous()
    if lengths is None:
        return k, v, table
    dead = torch.zeros(num_pages * ps, dtype=torch.bool, device="cuda")
    dead[:ps] = True
    pos = torch.arange(pps * ps, device="cuda")
    for b, n in enumerate(lengths):
        p = pos[pos >= n]
        dead[table[b].long()[p // ps] * ps + p % ps] = True
    for kv in (k, v):
        poison_quant(torch, kv, dead.view(1, num_pages, ps).expand(hkv, -1, -1))
    return k, v, table


def phase_quant_kernels(torch, quantized, errs):
    """B7, B8, B9 and QA against their plain versions (Hq 32, Hkv 8, D 128,
    bf16 q over int8 and e4m3 values with f32 scales), over caches whose
    scales (and e4m3 values) hold NaN at and past every length."""
    from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV

    gen = torch.Generator(device="cuda").manual_seed(5678)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def record(name, e, what, out=None, zero_rows=()):
        errs[name] = max(errs.get(name, 0.0), e)
        print(f"  {what}: max|diff| {e:.3e}")
        if out is not None:
            check(bool(torch.isfinite(out).all()), f"{what}: output finite over NaN-poisoned K/V")
            for r in zero_rows:
                check(bool((out[r] == 0).all()), f"{what}: row {r} (length 0) is exactly 0")
        check(e <= BF16_TOL, f"{what} within {BF16_TOL}")

    for dname in QUANT_DTYPES:
        dtype = getattr(torch, dname)
        # B7: the stacked cache of 2 layers, layer 1.
        lens = [0, 1, 63, 64, 65, 544, 2048]
        k, v = (quantized.quantize_kv(randn(2, len(lens), 8, 2048, 128), dtype) for _ in "kv")
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dead = torch.arange(2048, device="cuda")[None, :] >= lengths[:, None]
        for kv in (k, v):
            poison_quant(torch, kv, dead[None, :, None, :].expand(2, -1, 8, -1))
        q = randn(len(lens), 32, 1, 128)
        out = quantized.flash_attention_decode_quantized(q, k, v, lengths, layer=1)
        ref = quantized.flash_attention_decode_quantized_plain(q, k, v, lengths, layer=1)
        record("quant_decode", max_err(out, ref), f"B7 {dname} lengths {lens}", out, [0])
        del k, v
        held_contiguous_decodes(torch, None, quantized, errs, gen, CONTIG_DECODE_CASES["llama"],
                                (dname,))

        for ps in (16, 128):
            # B8: B5's length set.
            lens = [0, 1, ps - 1, ps, ps + 1, 2048, 777, 2 * ps + 1]
            k, v, table = quant_pool(torch, quantized, randn, gen, ps, len(lens), dtype, lens)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = randn(len(lens), 32, 1, 128)
            out = quantized.paged_attention_decode_quantized(q, k, v, lengths, table)
            ref = quantized.paged_attention_decode_quantized_plain(q, k, v, lengths, table)
            record("quant_paged_decode", max_err(out, ref),
                   f"B8 {dname} page_size {ps}, lengths {lens}", out, [0])
            # QA: decode rows and a 100-token chunk, paged (an inactive row, a
            # row past the table) and into the contiguous cache.
            for s, starts, act in ((1, [0, 5, ps - 1, 2048, 37, 2 * ps, 1, 9],
                                    [1, 1, 1, 1, 0, 1, 1, 1]),
                                   (100, [0, ps - 3, 2048 - 40, 3], [1, 1, 1, 0])):
                b = len(starts)
                nk, nv = (randn(b, s, 8, 128).transpose(1, 2) for _ in "kv")
                lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
                active = torch.tensor(act, dtype=torch.bool, device="cuda")
                k, v, table = quant_pool(torch, quantized, randn, gen, ps, b, dtype, [2048] * b)
                cont = [quantized.quantize_kv(randn(b, 8, 2048 + s, 128), dtype) for _ in "kv"]
                for mode, (kc, vc), tbl, act_ in (("paged", (k, v), table, active),
                                                  ("contiguous", cont, None, None)):
                    ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (kc, vc)]
                    quantized.quantize_append(nk, nv, kc, vc, lengths, tbl, act_)
                    quantized.quantize_append_plain(nk, nv, *ref, lengths, tbl, act_)
                    same = all(
                        torch.equal(g.values.view(torch.uint8), w.values.view(torch.uint8))
                        and torch.equal(g.scales.view(torch.int32), w.scales.view(torch.int32))
                        for g, w in zip((kc, vc), ref))
                    errs["quant_append"] = 0.0 if same else float("inf")
                    print(f"  QA {dname} {mode}, page_size {ps}, S {s}, starts {starts}: "
                          f"bit-identical to plain: {same}")
                    check(same, "QA writes exactly what quantize_kv + the indexed write writes")
                del cont

    def pools(i, ps, d, hkv, lengths, _):
        # Values alternate between int8 and e4m3 from case to case.
        return quant_pool(torch, quantized, randn, gen, ps, 4, getattr(torch, QUANT_DTYPES[i % 2]),
                          lengths, capacity=5120, d=d, hkv=hkv)

    held_extends(
        torch, errs, "quant_paged_extend",
        lambda q, k, v, off, kvl, t, w: quantized.paged_attention_extend_quantized(
            q, k, v, off, kvl, t, window=w),
        lambda q, k, v, off, kvl, t, w: quantized.paged_attention_extend_quantized_plain(
            q, k, v, off, kvl, t, window=w),
        pools, "B9 (int8 / e4m3 in turn)")


# Phase 3e: the windows every attention kernel takes: one key, an edge
# inside a 64-key tile (and a page or split), Mistral-7B's 4096, and one at
# least every length (it never binds).
WINDOW_SIZES = (1, 100, 4096, 8192)
# Mistral-7B's and Qwen2-7B's attention widths (q heads, kv heads).
WINDOW_HEADS = ((32, 8), (28, 4))


def phase_window_kernels(torch, ops, errs):
    """B2 and the windows of D1, B4, B5, B6, B7, B8, B9 against their plain
    versions at Mistral widths (Hq 32, Hkv 8, D 128; B2 and D1 also at
    Qwen2's 28 / 4, group 7), contexts up to 5152 keys, over caches and
    pools NaN at and past every length. B2 runs where the window binds
    (W < Skv); a window of at least Skv is P's launch. The plain versions
    take q in fp32 and return fp32: with a window of one key the output is
    one V row, of magnitude up to 4-8, where a bf16 plain result would add a
    second rounding of one bf16 step (0.03125)."""
    flash_fwd, flash_decode = ops["flash_fwd"], ops["flash_decode"]
    flash_chunked = ops["flash_chunked"]
    pa, qz = ops["paged_attention"], ops["quantized"]
    gen = torch.Generator(device="cuda").manual_seed(6060)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def record(name, e, what, out, zero_rows=()):
        errs[name] = max(errs.get(name, 0.0), e)
        print(f"  {what}: max|diff| {e:.3e}")
        check(bool(torch.isfinite(out).all()), f"{what}: output finite over NaN tails")
        for r in zero_rows:
            check(bool((out[r] == 0).all()), f"{what}: row {r} (no key) is exactly 0")
        check(e <= BF16_TOL, f"{what} within {BF16_TOL}")

    # B2 (P where the window cannot bind): the model's transposed views.
    for hq, hkv in WINDOW_HEADS:
        for b, sq, skv in ((1, 5120, 5120), (2, 1000, 1000), (1, 256, 1024)):
            q = randn(b, sq, hq, 128).transpose(1, 2)
            k, v = (randn(b, skv, hkv, 128).transpose(1, 2) for _ in "kv")
            for w in WINDOW_SIZES:
                before = (flash_fwd.WINDOWED_PREFILL.launches, flash_fwd.PREFILL.launches)
                out = flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=w)
                torch.cuda.synchronize()
                binds = w < skv
                got = (flash_fwd.WINDOWED_PREFILL.launches - before[0],
                       flash_fwd.PREFILL.launches - before[1])
                check(got == (int(binds), int(not binds)),
                      f"window {w} of {skv} keys launches {'B2' if binds else 'P'}, got {got}")
                e = max_err(out, flash_fwd.flash_attention_fwd_plain(q.float(), k, v, causal=True,
                                                                     window=w))
                record("flash_fwd_window" if binds else "flash_fwd", e,
                       f"{'B2' if binds else 'P '} Hq {hq} Hkv {hkv} B {b} Sq {sq} Skv {skv} "
                       f"window {w}", out)
            del q, k, v

    # D1 (+ D2) over a stacked cache of capacity 5152.
    lens = [5152, 5000, 4097, 4096, 100, 1, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for hq, hkv in WINDOW_HEADS:
        kc, vc = randn(2, len(lens), hkv, 5152, 128), randn(2, len(lens), hkv, 5152, 128)
        for i, n in enumerate(lens):  # uninitialised cache tail
            kc[:, i, :, n:] = float("nan")
            vc[:, i, :, n:] = float("nan")
        q = randn(len(lens), hq, 1, 128)
        splits = ops["dispatch"].decode_num_splits(len(lens), hkv, 5152, 128)
        for w in WINDOW_SIZES:
            acc, m, l = flash_decode.decode_partials(q, kc[1], vc[1], lengths, 128 ** -0.5,
                                                     splits, w)
            ref = flash_decode.decode_partials_plain(q.float(), kc[1], vc[1], lengths, 128 ** -0.5,
                                                     splits, w)
            e1 = max(max_err(x, y) for x, y in zip((acc, m, l), ref))
            errs["decode_partials"] = max(errs.get("decode_partials", 0.0), e1)
            check(e1 <= 1e-2, f"D1 partials window {w} (fp32 sums of the same inputs) within 1e-2")
            out = flash_decode.flash_attention_decode(q, kc, vc, lengths, window=w, layer=1)
            ref = flash_decode.flash_attention_decode_plain(q.float(), kc, vc, lengths, window=w,
                                                            layer=1)
            record("decode_combine", max_err(out, ref),
                   f"D1 + D2 Hq {hq} Hkv {hkv} lengths {lens} window {w} (partials {e1:.3e})",
                   out, [6])
            if w >= max(lens):
                check(torch.equal(out, flash_decode.flash_attention_decode(q, kc, vc, lengths,
                                                                           layer=1)),
                      "D1 + D2: a window of at least the length is no window")
        del kc, vc
    held_contiguous_decodes(torch, flash_decode, qz, errs, gen, CONTIG_DECODE_CASES["window"])

    # B4: the verify shape and a chunk, windows crossing the chunk.
    for name, s, offs in (("verify S5", 5, [0, 100, 4100, 5000]),
                          ("chunk S256", 256, [0, 77, 3900, 4864])):
        q, k, v, off, kvl = chunked_inputs(torch, gen, torch.bfloat16, s, 5152, offs, None, 128)
        for w in WINDOW_SIZES:
            out = flash_chunked.flash_attention_chunked(q, k, v, off, kvl, window=w)
            ref = flash_chunked.flash_attention_chunked_plain(q.float(), k, v, off, kvl, window=w)
            record("flash_chunked", max_err(out, ref), f"B4 {name} q_offset {offs} window {w}",
                   out)
        del q, k, v

    # B5 (+ D2) and B6 over pools of 5120 keys a row.
    for ps in (16, 128):
        lens = [0, 1, 100, 4095, 4097, 5120, 4500, 2 * ps + 1]
        kp, vp, table = paged_pool(torch, randn, gen, ps, rows=len(lens), capacity=5120,
                                   layers=1)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        poison_past(torch, kp, table, lengths)
        poison_past(torch, vp, table, lengths)
        q = randn(len(lens), 32, 1, 128)
        for w in WINDOW_SIZES:
            out = pa.paged_attention_decode(q, kp[0], vp[0], lengths, table, window=w)
            ref = pa.paged_attention_decode_plain(q.float(), kp[0], vp[0], lengths, table, window=w)
            record("paged_decode", max_err(out, ref),
                   f"B5 page_size {ps} lengths {lens} window {w}", out, [0])
        del kp, vp
        off = torch.tensor([0, 3900, 4864, 0], dtype=torch.int32, device="cuda")
        kvl = torch.tensor([256, 4156, 5120, 0], dtype=torch.int32, device="cuda")
        kp, vp, table = paged_pool(torch, randn, gen, ps, rows=4, capacity=5120, layers=1)
        poison_past(torch, kp, table, kvl)
        poison_past(torch, vp, table, kvl)
        q = randn(4, 256, 32, 128).transpose(1, 2)
        for w in WINDOW_SIZES:
            out = pa.paged_attention_extend(q, kp[0], vp[0], off, kvl, table, window=w)
            ref = pa.paged_attention_extend_plain(q.float(), kp[0], vp[0], off, kvl, table,
                                                  window=w)
            record("paged_extend", max_err(out, ref),
                   f"B6 page_size {ps} S 256 q_offset {off.tolist()} window {w}", out, [3])
        del kp, vp

    # B7 (+ D2), B8 (+ D2), B9 over int8 and e4m3.
    for dname in QUANT_DTYPES:
        dtype = getattr(torch, dname)
        lens = [0, 1, 100, 4097, 5000, 5152]
        k, v = (qz.quantize_kv(randn(2, len(lens), 8, 5152, 128), dtype) for _ in "kv")
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dead = torch.arange(5152, device="cuda")[None, :] >= lengths[:, None]
        for kv in (k, v):
            poison_quant(torch, kv, dead[None, :, None, :].expand(2, -1, 8, -1))
        q = randn(len(lens), 32, 1, 128)
        for w in WINDOW_SIZES:
            out = qz.flash_attention_decode_quantized(q, k, v, lengths, window=w, layer=1)
            ref = qz.flash_attention_decode_quantized_plain(q.float(), k, v, lengths, window=w,
                                                            layer=1)
            record("quant_decode", max_err(out, ref), f"B7 {dname} lengths {lens} window {w}",
                   out, [0])
        del k, v
        lens = [0, 1, 100, 4095, 4097, 5120, 4500]
        k, v, table = quant_pool(torch, qz, randn, gen, 16, len(lens), dtype, lens, capacity=5120)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(len(lens), 32, 1, 128)
        for w in WINDOW_SIZES:
            out = qz.paged_attention_decode_quantized(q, k, v, lengths, table, window=w)
            ref = qz.paged_attention_decode_quantized_plain(q.float(), k, v, lengths, table,
                                                            window=w)
            record("quant_paged_decode", max_err(out, ref),
                   f"B8 {dname} page_size 16 lengths {lens} window {w}", out, [0])
        del k, v
        off = torch.tensor([0, 3900, 4864, 0], dtype=torch.int32, device="cuda")
        kvl = torch.tensor([256, 4156, 5120, 0], dtype=torch.int32, device="cuda")
        k, v, table = quant_pool(torch, qz, randn, gen, 16, 4, dtype, kvl.tolist(), capacity=5120)
        q = randn(4, 256, 32, 128).transpose(1, 2)
        for w in WINDOW_SIZES:
            out = qz.paged_attention_extend_quantized(q, k, v, off, kvl, table, window=w)
            ref = qz.paged_attention_extend_quantized_plain(q.float(), k, v, off, kvl, table,
                                                            window=w)
            record("quant_paged_extend", max_err(out, ref),
                   f"B9 {dname} page_size 16 S 256 q_offset {off.tolist()} window {w}", out, [3])
        del k, v
    torch.cuda.empty_cache()


# Phase 3c shapes (rows T, K, N): the Llama-3-8B projections at decode,
# admission and prefill row counts, either side of the kernels' decode /
# prefill crossover (DECODE_MAX_T = 16), a speculative verify, a chunk.
QMM_CASES = {
    "q_proj / o_proj, T 1": (1, 4096, 4096),
    "k_proj / v_proj, T 4": (4, 4096, 1024),
    "fused qkv_proj, T 8": (8, 4096, 6144),
    "gate_proj / up_proj, T 4": (4, 4096, 14336),
    "fused gate_up_proj, T 8": (8, 4096, 28672),
    "down_proj, T 4 (K 14336)": (4, 14336, 4096),
    "q_proj, T 16 (the last decode row count)": (16, 4096, 4096),
    "q_proj, T 17 (the first prefill row count)": (17, 4096, 4096),
    "q_proj, T 20 (a verify round, B 4 x (gamma + 1))": (20, 4096, 4096),
    "down_proj, T 37": (37, 14336, 4096),
    "q_proj, T 63": (63, 4096, 4096),
    "q_proj, T 64": (64, 4096, 4096),
    "q_proj, T 256 (a chunk)": (256, 4096, 4096),
    "gate_proj, T 2048 (prefill)": (2048, 4096, 14336),
    "k_proj / v_proj, T 2048": (2048, 4096, 1024),
    "down_proj, T 2048": (2048, 14336, 4096),
    "lm_head, T 4 (N 128256, padded to 129024)": (4, 4096, 128256),
    "ragged K 300, T 5": (5, 300, 520),
    "K 200 (int4 K_pad 256: 2 groups, one pack block), T 3": (3, 200, 130),
}
# Cases of x that are not bf16 rows of 16-byte aligned strides: (T, K, N,
# dtype name, the width x is sliced from).
QMM_X_CASES = {
    "f16, T 8": (8, 4096, 4096, "float16", None),
    "f16, T 2048": (2048, 4096, 4096, "float16", None),
    "T 2048, x rows of 301 elements sliced to K 300 (unaligned: the decode design)":
        (2048, 300, 520, "bfloat16", 301),
}
# kernel name -> (bits, projections per layer of the tree it runs on)
QMM_KERNELS = {"quantized_matmul": (8, 7), "quantized_matmul_int4": (4, 4)}


def phase_qmm_kernels(torch, qmm, errs):
    """B10 and B11 against their fp32 plain versions (x at unit scale,
    weights normal with std fan_in ** -0.5 quantized on the card), in
    every case on the plan's route and, where the plan splits K, also in
    one pass over K; every output must repeat bit for bit. The kernels
    round an fp32 sum to bf16 once; a bf16 plain result would add a second
    rounding, one bf16 step (0.03125) apart for outputs of 4-8."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    cases = {what: (t, k, n, "bfloat16", None) for what, (t, k, n) in QMM_CASES.items()}
    cases.update(QMM_X_CASES)
    for what, (t, k, n, dtype, width) in cases.items():
        x = torch.randn((t, width or k), generator=gen, device="cuda").to(getattr(torch, dtype))
        x = x[:, :k]
        w = torch.randn((k, n), generator=gen, device="cuda").mul_(k ** -0.5)
        for name, (bits, _) in QMM_KERNELS.items():
            qw = (qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4)(w)
            k_pad = qw.values.shape[0] * (2 if bits == 4 else 1)
            aligned = x.data_ptr() % 16 == 0 and x.stride(0) * x.element_size() % 16 == 0
            plan = qmm.qmm_plan(t, k, n, k_pad, qw.values.shape[1], bits == 4, aligned)
            out = qmm.quantized_matmul(x, qw)
            # The fp32 plain version on the same (exactly widened) inputs.
            ref = qmm.quantized_matmul_plain(x.float(), qw)
            e = max_err(out, ref)
            same = torch.equal(out, qmm.quantized_matmul(x, qw))
            kname = "B10 int8" if bits == 8 else "B11 int4"
            print(f"  {kname} {what} (K {k}, N {n}, padded {tuple(qw.values.shape)}): "
                  f"{plan.route}, {plan.splits} split(s), max|diff| {e:.3e}, repeat "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            check(tuple(out.shape) == (t, n) and bool(torch.isfinite(out).all()),
                  f"{name} {what}: finite [{t}, {n}] output")
            check(e <= BF16_TOL, f"{name} {what} within {BF16_TOL}")
            check(same, f"{name} {what}: a second call gives the same bits")
            if plan.splits > 1:
                one = qmm.quantized_matmul(x, qw, splits=1)
                e1, e_split = max_err(one, ref), max_err(out, one)
                print(f"    one pass over K: max|diff| {e1:.3e}, against the split {e_split:.3e}")
                check(max(e1, e_split) <= BF16_TOL, f"{name} {what}: one pass over K agrees")
                e = max(e, e1)
            errs[name] = max(errs.get(name, 0.0), e)
        del x, w, qw, out, ref


def serving_requests(cfg):
    """24 requests: prompt lengths uniform in 128-1024, max_new_tokens in
    32-96, ids uniform over the vocabulary, all from numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, 24)
    news = rng.integers(32, 97, 24)
    return [(rid, rng.integers(0, cfg.vocab_size, int(n)).tolist(), int(m))
            for rid, (n, m) in enumerate(zip(plens, news))]


SERVING_RUNS = {
    "A whole-prompt": dict(slots=8, page_size=128, pages_per_seq=16, num_pages=129,
                           prefill_group=4, decode_chunk=8),
    "B chunked": dict(slots=8, page_size=16, pages_per_seq=128, num_pages=561,
                      prefill_chunk=256),
    "C preemption": dict(slots=8, page_size=16, pages_per_seq=128, num_pages=321,
                         prefill_chunk=256),
    # Runs A and B over quantized pages.
    "D int8 whole-prompt": dict(slots=8, page_size=128, pages_per_seq=16, num_pages=129,
                                prefill_group=4, decode_chunk=8, kv_dtype="int8"),
    "E e4m3 chunked": dict(slots=8, page_size=16, pages_per_seq=128, num_pages=561,
                           prefill_chunk=256, kv_dtype="float8_e4m3fn"),
    # Run A with int8 weights, run D with fused int4 weights (phase 4d's trees).
    "F int8 weights": dict(slots=8, page_size=128, pages_per_seq=16, num_pages=129,
                           prefill_group=4, decode_chunk=8, weights="int8"),
    "G int4 weights, int8 pages": dict(slots=8, page_size=128, pages_per_seq=16,
                                       num_pages=129, prefill_group=4, decode_chunk=8,
                                       kv_dtype="int8", weights="int4"),
}
# The kernels of the dense and of the quantized serving routes.
DENSE_SERVING = ("paged_decode", "paged_extend", "paged_append")
QUANT_SERVING = ("quant_paged_decode", "quant_paged_extend", "quant_append")


def teacher_forced(torch, cfg, params, prompt, tokens):
    """Per generated position: (the engine token's logit is within
    LOGIT_MAX_TOL of the largest, it is the argmax) under one contiguous
    prefill (kernel P) over prompt + tokens[:-1]."""
    from flash_attention_cute_tpu_torch.models.transformer import forward

    ids = torch.tensor([prompt + tokens[:-1]], device="cuda")
    with torch.no_grad():
        logits = forward(params, cfg, ids)[0][0, len(prompt) - 1:]
    tok = torch.tensor(tokens, device="cuda")
    chosen = logits.gather(1, tok[:, None])[:, 0]
    top = logits.max(dim=1).values
    return (chosen >= top - LOGIT_MAX_TOL).tolist(), (chosen == top).tolist()


def quantized_tf_state(torch, cfg, kw):
    """One row's quantized state for `teacher_forced_paged`, of the run's
    (engine options `kw`) value dtype and page size."""
    from flash_attention_cute_tpu_torch.runtime.paged_cache import create_quantized_paged_state

    state = create_quantized_paged_state(cfg, kw["pages_per_seq"] + 1, kw["page_size"], 1,
                                         kw["pages_per_seq"], dtype=kw["kv_dtype"])
    state.page_table = torch.arange(1, kw["pages_per_seq"] + 1, dtype=torch.int32,
                                    device="cuda")[None]
    return state


def teacher_forced_paged(torch, cfg, params, state, prompt, tokens, chunk):
    """`teacher_forced` for a quantized run: the request through
    `forward_paged(plain_attention=True)` on a quantized state of the run's
    dtype and page size, admitted as the run admits it (one prefill, or
    extends of `chunk` tokens), then one extend over the generated tokens.
    Each K/V row is quantized as the engine quantized it."""
    import dataclasses
    from flash_attention_cute_tpu_torch.runtime.paged_forward import forward_paged

    state = dataclasses.replace(state, lengths=torch.zeros_like(state.lengths))
    with torch.no_grad():
        for i in range(0, len(prompt), chunk or len(prompt)):
            ids = torch.tensor([prompt[i: i + (chunk or len(prompt))]], device="cuda")
            logits, state = forward_paged(params, cfg, ids, state,
                                          mode="extend" if chunk else "prefill",
                                          plain_attention=True)
        rows = [logits[0, -1:]]
        if len(tokens) > 1:
            ids = torch.tensor([tokens[:-1]], device="cuda")
            rows.append(forward_paged(params, cfg, ids, state, mode="extend",
                                      plain_attention=True)[0][0])
    logits = torch.cat(rows)
    tok = torch.tensor(tokens, device="cuda")
    chosen = logits.gather(1, tok[:, None])[:, 0]
    top = logits.max(dim=1).values
    return (chosen >= top - LOGIT_MAX_TOL).tolist(), (chosen == top).tolist()


def phase_serving(torch, cfg, params, kernels, path_counts):
    """Runs A-G of the serving engine over 24 requests; launch counts per
    run, every request's tokens teacher-forced, and the numbers. Runs F and
    G serve the quantized trees of phase 4d, built for the run and dropped
    after it, and are teacher-forced through their dequantized images."""
    from flash_attention_cute_tpu_torch.models.quantize import dequantize_params
    from flash_attention_cute_tpu_torch.runtime.engine import ServingEngine

    reqs = serving_requests(cfg)
    n = cfg.num_layers
    # The peak of the phases so far; each run then measures its own.
    results = {"peak_before_serving_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name, kw in SERVING_RUNS.items():
        quant = "kv_dtype" in kw
        if quant:
            kw = {**kw, "kv_dtype": getattr(torch, kw["kv_dtype"])}
        weights = kw.get("weights")
        kw = {k: v for k, v in kw.items() if k != "weights"}
        run_params = quantized_tree(torch, params, weights) if weights else params
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(run_params, cfg, **kw)
        pool_bytes = sum(t.numel() * t.element_size() for f, t in vars(eng.state).items()
                         if f not in ("page_table", "lengths"))
        for rid, prompt, new in reqs:
            eng.submit(rid, prompt, new)
        out, wall, counts = counted_run(torch, kernels, eng.run)
        peak = torch.cuda.max_memory_allocated()
        path_counts[name] = counts
        fw = eng.forwards
        print(f"  ({name}) {kw}: {wall:.3f} s, forwards {fw}, launches {counts}, "
              f"stats {eng.stats}; pool {pool_bytes / 1e9:.4f} GB, peak memory "
              f"{peak / 1e9:.3f} GB")
        check(sorted(out) == list(range(len(reqs))) and not eng.failed,
              f"({name}) every request finishes, none fails")
        check(eng.native, f"({name}) runs on the native scheduler")
        # The route's paged decode (B5 or B8), extend (B6 or B9) and append
        # (the copy or QA); none of the other route's.
        dec, ext, app = QUANT_SERVING if quant else DENSE_SERVING
        check(counts[dec] == n * fw["decode"] == counts["decode_combine"],
              f"({name}) {dec} and D2 launched layers x decode forwards")
        check(counts[ext] == n * fw["extend"], f"({name}) {ext} = layers x extends")
        check(counts["flash_fwd"] == n * fw["prefill"], f"({name}) P = layers x prefills")
        check(counts[app] == n * sum(fw.values()), f"({name}) {app} = layers x forwards")
        check(all(counts[k] == 0 for k in (DENSE_SERVING if quant else QUANT_SERVING)),
              f"({name}) no kernel of the other route")
        check(counts["decode_partials"] == 0 and counts["quant_decode"] == 0,
              f"({name}) no contiguous decode")
        for kname, (bits, per_layer) in QMM_KERNELS.items():
            want = (per_layer * n + 1) * sum(fw.values()) if weights == f"int{bits}" else 0
            check(counts[kname] == want,
                  f"({name}) {kname} = (projections x layers + 1) x forwards ({want})")
        if kw.get("prefill_chunk"):
            check(fw["extend"] > 0, f"({name}) admission by extend")
        else:
            check(fw["prefill"] > 0 and fw["extend"] == 0, f"({name}) admission by prefill")
        if "preemption" in name:
            check(eng.stats["preemptions"] > 0, f"({name}) preempts")

        near, top = [], []
        # Teacher forcing runs the dense weights, or the exact dense image of
        # the run's quantized weights.
        tf_params = dequantize_params(run_params) if weights else params
        if quant:
            tf_state = quantized_tf_state(torch, cfg, kw)
        for rid, prompt, _ in reqs:
            if quant:
                a, b = teacher_forced_paged(torch, cfg, tf_params, tf_state, prompt, out[rid],
                                            kw.get("prefill_chunk", 0))
            else:
                a, b = teacher_forced(torch, cfg, tf_params, prompt, out[rid])
            near += a
            top += b
        del tf_params
        if quant:
            del tf_state
        print(f"  ({name}) teacher-forced: {sum(near)}/{len(near)} tokens within "
              f"{LOGIT_MAX_TOL} of the top logit, argmax share {sum(top) / len(top):.4f}")
        check(all(near), f"({name}) every engine token within {LOGIT_MAX_TOL} of the top logit")
        check(sum(top) / len(top) >= ARGMAX_SHARE_MIN,
              f"({name}) argmax share of the engine tokens >= {ARGMAX_SHARE_MIN}")
        ttft = sorted(m["ttft_s"] for m in eng.request_metrics)
        gen_tokens = eng.stats["tokens_generated"]
        results[name] = {
            "wall_s": wall,
            "generated_tokens": gen_tokens,
            "generated_tokens_per_s": gen_tokens / wall,
            "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_p90_s": ttft[int(0.9 * (len(ttft) - 1))],
            "decode_rounds": eng.decode_rounds,
            "decode_ms_per_round": 1e3 * eng.decode_round_s / max(eng.decode_rounds, 1),
            "device_calls": eng.stats["device_calls"],
            "prefills": eng.stats["prefills"],
            "preemptions": eng.stats["preemptions"],
            "teacher_forced_argmax_share": sum(top) / len(top),
            "pool_gb": pool_bytes / 1e9,
            "weights_gb": tree_bytes(run_params) / 1e9,
            "peak_memory_gb": peak / 1e9,
        }
        del eng, out, run_params
        torch.cuda.empty_cache()
    results["A whole-prompt"].update(profile_serving(torch, cfg, params, reqs))
    return results


def phase_serving_forward(torch, cfg, params, kernels):
    """The serving forward (`forward_paged`) on the kernel route against its
    plain_attention route, teacher-forced on the same ids through the same
    permuted page table, each route on a pool of its own, for a bf16, an
    int8 and an e4m3 pool: a prefill of 4 padded prompts (P), a 256-token
    extend (B6 / B9), two decode steps (B5 / B8, + D2). The kernel route
    must launch its kernels and the plain route none (the append kernel or
    QA writes the pools on both). These comparison launches are not a main
    path's: the serving runs reset the counts before each run."""
    import numpy as np
    from flash_attention_cute_tpu_torch.runtime.paged_cache import (
        create_paged_state,
        create_quantized_paged_state,
    )
    from flash_attention_cute_tpu_torch.runtime.paged_forward import forward_paged

    b, ps, pps = 4, 16, 64
    rng = np.random.default_rng(1)
    steps = [("prefill", 300, torch.tensor([300, 257, 128, 17], dtype=torch.int32,
                                           device="cuda")),
             ("extend", 256, None), ("decode", 1, None), ("decode", 1, None)]
    steps = [(mode, torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to("cuda"), vl)
             for mode, s, vl in steps]
    gen = torch.Generator(device="cuda").manual_seed(2)
    table = (torch.randperm(b * pps, generator=gen, device="cuda") + 1).view(b, pps)
    attention = ("flash_fwd", "paged_extend", "paged_decode", "decode_combine",
                 "decode_partials", "quant_decode", "quant_paged_decode", "quant_paged_extend")
    n = cfg.num_layers
    for pool in ("bf16",) + QUANT_DTYPES:
        logits, launches = {}, {}
        for plain in (False, True):
            if pool == "bf16":
                state = create_paged_state(cfg, b * pps + 1, ps, b, pps)
            else:
                state = create_quantized_paged_state(cfg, b * pps + 1, ps, b, pps,
                                                     dtype=getattr(torch, pool))
            state.page_table = table.to(torch.int32)
            for k in kernels.values():
                k.launches = 0
            with torch.no_grad():
                outs = []
                for mode, ids, valid in steps:
                    out, state = forward_paged(params, cfg, ids, state, mode=mode,
                                               valid_len=valid, plain_attention=plain)
                    outs.append(out)
            torch.cuda.synchronize()
            logits[plain] = outs
            launches[plain] = {k: kern.launches for k, kern in kernels.items()}
            del state
        dec, ext, _ = DENSE_SERVING if pool == "bf16" else QUANT_SERVING
        print(f"  {pool} pool: kernel route launches {launches[False]}; plain route "
              f"{launches[True]}")
        check(launches[False]["flash_fwd"] == n and launches[False][ext] == n
              and launches[False][dec] == 2 * n == launches[False]["decode_combine"],
              f"{pool} pool: the kernel route runs P, {ext} and {dec} + D2 once per layer "
              "and forward")
        check(all(launches[True][k] == 0 for k in attention),
              f"{pool} pool: the plain route launches no attention kernel")
        for (mode, _, _), a, r in zip(steps, logits[False], logits[True]):
            check_logits(torch, f"{pool} pool: serving {mode}, kernel vs plain", a, r)
        del logits
        torch.cuda.empty_cache()


def profile_serving(torch, cfg, params, reqs, rounds=3):
    """Device busy share over a few decode rounds of run A's engine with 8
    requests resident (the 8 with the most new tokens, so that no round is
    cut short by a finishing request): device time per round from
    torch.profiler over `rounds` rounds, over the wall time per round of
    the `rounds` rounds just before them, timed without the profiler
    (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    from flash_attention_cute_tpu_torch.runtime.engine import ServingEngine

    eng = ServingEngine(params, cfg, **SERVING_RUNS["A whole-prompt"])
    for rid, prompt, new in sorted(reqs, key=lambda r: -r[2])[:8]:
        eng.submit(rid, prompt, new)
    with torch.no_grad():
        eng.step()  # admits all 8, then one decode round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                eng.step()
            torch.cuda.synchronize()
            prof_wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        return {"decode_busy_share": "not measured: the profiler recorded no device time"}
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=lambda e: -dev_us(e))[:8]
    return {
        "profiled_decode_rounds": rounds,
        "wall_ms_per_round": wall_ms / rounds,
        "profiled_wall_ms_per_round": prof_wall_ms / rounds,
        "device_busy_ms_per_round": busy_ms / rounds,
        "decode_busy_share": busy_ms / wall_ms,
        "top_device_kernels_ms_per_round": [
            [e.key[:60], dev_us(e) / 1e3 / rounds, e.count // rounds] for e in top],
    }


def phase_main_path(torch, cfg, params, kernels, counts):
    from flash_attention_cute_tpu_torch.models.cache import KVCache
    from flash_attention_cute_tpu_torch.models.transformer import forward
    from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate
    import numpy as np

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT))
    ids = torch.from_numpy(ids).to("cuda")

    # Teacher forcing: the same prompt, then the same next token, through the
    # kernel path and the plain-attention path.
    diffs = []
    with torch.no_grad():
        caches, last = {}, {}
        for plain in (False, True):
            cache = KVCache.create(cfg, B, CAPACITY)
            logits, caches[plain] = forward(params, cfg, ids, cache=cache, mode="prefill",
                                            plain_attention=plain)
            last[plain] = logits
        diffs.append(("prefill", last[False], last[True]))
        tok = last[True][:, -1].argmax(-1)[:, None]
        del last
        step = {p: forward(params, cfg, tok, cache=caches[p], mode="decode",
                           plain_attention=p)[0] for p in (False, True)}
        diffs.append(("decode step", step[False], step[True]))
        del caches, step
    for name, a, b in diffs:
        check_logits(torch, f"teacher-forced {name}", a, b)
    del diffs
    torch.cuda.empty_cache()

    tokens, wall, launched = counted_run(
        torch, kernels, lambda: greedy_generate(params, cfg, ids, NEW, cache_capacity=CAPACITY))
    counts.update(launched)
    print(f"  greedy_generate B{B} prompt {PROMPT} new {NEW}: {wall:.3f} s, launches {counts}")
    check(tuple(tokens.shape) == (B, NEW), "token shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens in vocab")
    n = cfg.num_layers
    check(counts["flash_fwd"] == n, f"P launched once per layer in prefill ({n})")
    for name in ("decode_partials", "decode_combine"):
        check(counts[name] == n * (NEW - 1), f"{name} launched {n} x {NEW - 1}")
    return ids, tokens, wall


def counted_run(torch, kernels, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (result, wall s ending in a synchronise, counts)."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {name: k.launches for name, k in kernels.items()}


def check_logits(torch, name, a, b) -> list:
    """Logits `a` finite and within LOGIT_MAX_TOL / LOGIT_MEAN_TOL of the
    reference `b`; returns [max, mean] |diff|."""
    check(bool(torch.isfinite(a).all()), f"{name} logits finite")
    d = (a - b).abs()
    diff = [d.max().item(), d.mean().item()]
    print(f"  {name} logits {tuple(a.shape)}: max|diff| {diff[0]:.4f}, mean|diff| "
          f"{diff[1]:.5f}, ref std {b.std().item():.3f}, argmax agree "
          f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.4f}")
    check(diff[0] <= LOGIT_MAX_TOL and diff[1] <= LOGIT_MEAN_TOL,
          f"{name} logits within max {LOGIT_MAX_TOL} / mean {LOGIT_MEAN_TOL}")
    return diff


def phase_extend_logits(torch, cfg, params, ids, tokens, kernels):
    """The extend mode on the kernel route (B4): prefill 512, then extends
    of 5 and 59 tokens, against one 576-token prefill (P) at the same
    positions; then over an int8 cache, the kernel route (QA, B4 over the
    dequantized slab) against the plain route over a copy of one cache."""
    import dataclasses
    from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
    from flash_attention_cute_tpu_torch.models.transformer import forward

    n = cfg.num_layers
    full = torch.cat([ids, tokens], dim=1)
    chunks = ((PROMPT, PROMPT + 5), (PROMPT + 5, PROMPT + NEW))

    def extends(cache, plain=False):
        out = []
        for lo, hi in chunks:
            logits, cache = forward(params, cfg, full[:, lo:hi], cache=cache, mode="extend",
                                    plain_attention=plain)
            out.append(logits)
        return torch.cat(out, dim=1)

    with torch.no_grad():
        want = forward(params, cfg, full)[0][:, PROMPT:]
        cache = forward(params, cfg, ids, cache=KVCache.create(cfg, B, CAPACITY))[1]
        got, _, counts = counted_run(torch, kernels, lambda: extends(cache))
        check(counts["flash_chunked"] == 2 * n and counts["decode_partials"] == 0,
              f"extends of 5 and 59 tokens launch B4 2 x {n} times, no decode kernel")
        check_logits(torch, "extend 5 + 59 after prefill 512 vs one prefill of 576", got, want)
        del want, got, cache

        qc = QuantizedKVCache.create(cfg, B, CAPACITY, torch.int8)
        qc = forward(params, cfg, ids, cache=qc)[1]
        twin = dataclasses.replace(qc, **{f: getattr(qc, f).clone() for f in (
            "k_values", "k_scales", "v_values", "v_scales")})
        a, _, counts = counted_run(torch, kernels, lambda: extends(qc))
        check(counts["flash_chunked"] == 2 * n and counts["quant_append"] == 2 * n,
              f"int8-cache extends launch QA and B4 2 x {n} times")
        b, _, counts = counted_run(torch, kernels, lambda: extends(twin, plain=True))
        check(counts["flash_chunked"] == 0, "the plain route launches no B4")
        check_logits(torch, "int8-cache extend, kernel route vs plain route", a, b)
        del qc, twin, a, b
    torch.cuda.empty_cache()


# Phase 4e: speculative generation.
GAMMA = 4
SPEC_SAMPLING = {"temperature": 1.0, "top_k": 50}


def phase_speculative(torch, cfg, params, ids, kernels, path_counts, greedy_wall_s, label="",
                      sampled=True):
    """(i) speculative_generate with the target as its own draft, (ii) with
    a 2-layer draft of the target's widths (random weights from its own
    seeded generator), (iii) prompt_lookup_generate (ngram 2) on prompts
    that repeat a seeded 64-token segment 8 times, (iv) with `sampled`, a
    sampled run of (i), called twice with one seed. Launch counts per run
    (path `label` + the run's name); every greedy token teacher-forced
    through one contiguous prefill; (i)'s acceptance share >= 0.75."""
    import dataclasses
    import numpy as np
    from flash_attention_cute_tpu_torch.models.transformer import init_params
    from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate
    from flash_attention_cute_tpu_torch.runtime.sampling import SamplingParams
    from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate

    n = cfg.num_layers
    dcfg = dataclasses.replace(cfg, num_layers=2)
    draft = init_params(dcfg, generator=torch.Generator(device="cuda").manual_seed(1))
    seg = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, PROMPT // 8))
    lookup_ids = torch.from_numpy(np.tile(seg, (1, 8))).to("cuda")
    runs = {
        "spec self-draft": (ids, n, lambda: speculative_generate(
            params, cfg, params, cfg, ids, NEW, gamma=GAMMA, return_stats=True)),
        "spec 2-layer draft": (ids, 2, lambda: speculative_generate(
            params, cfg, draft, dcfg, ids, NEW, gamma=GAMMA, return_stats=True)),
        "prompt lookup": (lookup_ids, 0, lambda: prompt_lookup_generate(
            params, cfg, lookup_ids, NEW, gamma=GAMMA, ngram=2, return_stats=True)),
    }
    if sampled:
        runs["spec self-draft sampled"] = (ids, n, lambda: speculative_generate(
            params, cfg, params, cfg, ids, NEW, gamma=GAMMA, return_stats=True,
            sampling=SamplingParams(**SPEC_SAMPLING), seed=3))
    results = {}
    for name, (prompt_ids, draft_layers, fn) in runs.items():
        (tokens, stats), wall, counts = counted_run(torch, kernels, fn)
        path_counts[label + name] = counts
        rounds = stats["rounds"]
        share = stats["accepted_drafts"] / (rounds * GAMMA * B)
        print(f"  ({label}{name}) B{B} prompt {PROMPT} new {NEW} gamma {GAMMA}: {wall:.3f} s, "
              f"rounds {rounds}, accepted drafts {stats['accepted_drafts']} (share "
              f"{share:.4f}), launches {counts}")
        check(tuple(tokens.shape) == (B, NEW), f"({label}{name}) token shape")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              f"({label}{name}) tokens in vocab")
        # Prefills (P), one extend per model a round (B4), the draft's
        # gamma - 1 decodes a round (D1 + D2); nothing else.
        want = {"flash_fwd": n + draft_layers, "flash_chunked": (n + draft_layers) * rounds,
                "decode_partials": draft_layers * rounds * (GAMMA - 1),
                "decode_combine": draft_layers * rounds * (GAMMA - 1)}
        for kname, c in counts.items():
            check(c == want.get(kname, 0), f"({label}{name}) {kname} launched {want.get(kname, 0)} "
                  f"times, got {c}")
        results[name] = {
            "wall_s": wall, "tokens_per_s": B * NEW / wall, "rounds": rounds,
            "accepted_drafts": stats["accepted_drafts"], "acceptance_share": share,
            "ms_per_round_incl_prefill": 1e3 * wall / rounds,
        }
        if "sampled" in name:
            again, _, _ = counted_run(torch, kernels, fn)
            same = torch.equal(again[0], tokens)
            print(f"  ({label}{name}) second call with the same seed: tokens equal {same}")
            check(same, f"({label}{name}) one seed gives the same tokens")
            continue
        near, top = [], []
        for row in range(B):
            a, b = teacher_forced(torch, cfg, params, prompt_ids[row].tolist(),
                                  tokens[row].tolist())
            near += a
            top += b
        print(f"  ({label}{name}) teacher-forced: {sum(near)}/{len(near)} tokens within "
              f"{LOGIT_MAX_TOL} of the top logit, argmax share {sum(top) / len(top):.4f}")
        check(all(near), f"({label}{name}) every token within {LOGIT_MAX_TOL} of the top logit")
        check(sum(top) / len(top) >= ARGMAX_SHARE_MIN,
              f"({label}{name}) argmax share >= {ARGMAX_SHARE_MIN}")
        results[name]["teacher_forced_argmax_share"] = sum(top) / len(top)
    check(results["spec self-draft"]["acceptance_share"] >= 0.75,
          "self-draft acceptance share >= 0.75 (a wrong B4 mask or offset drives it to 0)")
    results["greedy_wall_s"] = greedy_wall_s
    results["greedy_tokens_per_s"] = B * NEW / greedy_wall_s
    del draft
    torch.cuda.empty_cache()
    return results


# Phase 4k: the HF surface (interop.torch_patch, HF state-dict conversion,
# the task heads) at Llama-3-8B widths over the main path's weights.
HF_PADDED_LENGTHS = (512, 400, 257, 1)
HF_DECODE_STEPS, HF_WINDOW, HF_NEW = 8, 256, 32


def hf_state_dict(params, cfg) -> dict:
    """The parameters under HF Llama's names, each Linear [out, in] as a
    transposed view (nothing is copied)."""
    lp = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_ln"],
          "lm_head.weight": params["lm_head"].T}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = lp["input_ln"][i]
        sd[pre + "post_attention_layernorm.weight"] = lp["post_ln"][i]
        for name in ("q", "k", "v", "o"):
            sd[pre + f"self_attn.{name}_proj.weight"] = lp[f"{name}_proj"][i].T
        for name in ("gate", "up", "down"):
            sd[pre + f"mlp.{name}_proj.weight"] = lp[f"{name}_proj"][i].T
    return sd


def add_counts(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def check_launched(counts: dict, want: dict, what: str) -> None:
    """Exactly the launches of `want`, no other kernel."""
    for name, c in counts.items():
        check(c == want.get(name, 0),
              f"{what}: {name} launched {want.get(name, 0)} times, got {c}")


class GrowingCache:
    """HF's `DynamicCache.update` for one layer: the first call keeps K / V
    as given (the projections' transposed views), each later call returns
    torch.cat([old, new]) along the sequence axis, one key longer a step."""

    def __init__(self, cat):
        self.cat, self.k, self.v = cat, None, None

    def update(self, k, v, layer_idx, cache_kwargs=None):
        if self.k is not None:
            k, v = self.cat([self.k, k], dim=-2), self.cat([self.v, v], dim=-2)
        self.k, self.v = k, v
        return k, v


def stand_in_attention(torch, cfg, params, window):
    """A module holding only what `attention_forward` reads: layer 0's
    q / k / v / o projections as bf16 Linears, an HF-style `config`,
    `head_dim` and `layer_idx`. Its o_proj keeps its input, the attention
    output, for the check."""
    import types

    lp = params["layers"]

    def linear(w):  # w [in, out] -> Linear with weight [out, in] (a view)
        lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=False, device="meta")
        lin.weight = torch.nn.Parameter(w.T, requires_grad=False)
        return lin

    class Recorder(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner, self.seen = inner, None

        def forward(self, x):
            self.seen = x
            return self.inner(x)

    mod = torch.nn.Module()
    for name in ("q", "k", "v"):
        setattr(mod, f"{name}_proj", linear(lp[f"{name}_proj"][0]))
    mod.o_proj = Recorder(linear(lp["o_proj"][0]))
    mod.config = types.SimpleNamespace(
        num_attention_heads=cfg.num_q_heads, num_key_value_heads=cfg.num_kv_heads,
        hidden_size=cfg.hidden_size, use_sliding_window=window is not None,
        sliding_window=window, max_window_layers=0)
    mod.head_dim, mod.layer_idx = cfg.head_dim, 0
    return mod


def phase_hf(torch, cfg, params, ids, bf16_tokens, kernels, path_counts):
    """(a) HF-named transposed views of the main path's parameters through
    `params_from_state_dict`, then greedy generation: phase 4's tokens and
    launch counts exactly. (b) `attention_forward` on a stand-in module
    (layer 0's projections, an HF-style config and a cache growing by
    torch.cat as HF's DynamicCache does) at B 4 x 512: an unpadded prefill
    (P), a right-padded one (B4), 8 decode steps (D1 + D2), then the same
    with a window of 256 (B2, windowed D1), each attention output within
    BF16_TOL of the fp32 reference on the same q / k / v; one torch.compile
    of a call of the op. (c) Where transformers imports: HF
    `LlamaForCausalLM` holding the same weights, `patch_llama()`, greedy
    over HF's DynamicCache, teacher-forced against the port's `forward`,
    and `sequence_classification_forward` kernel route vs plain route."""
    from flash_attention_cute_tpu_torch.interop import attention_forward, torch_patch
    from flash_attention_cute_tpu_torch.models import layers as L
    from flash_attention_cute_tpu_torch.models.convert import params_from_state_dict
    from flash_attention_cute_tpu_torch.ops.reference import attention_reference
    from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

    hf_counts = path_counts["hf"]
    out = {}

    # (a) conversion at full width, exact.
    t0 = time.perf_counter()
    converted = params_from_state_dict(hf_state_dict(params, cfg), cfg)
    torch.cuda.synchronize()
    out["convert_s"] = time.perf_counter() - t0
    tokens, wall, counts = counted_run(
        torch, kernels, lambda: greedy_generate(converted, cfg, ids, NEW, cache_capacity=CAPACITY))
    add_counts(hf_counts, counts)
    same = torch.equal(tokens, bf16_tokens)
    print(f"  (a) params_from_state_dict over HF-named views ({out['convert_s']:.2f} s), greedy "
          f"B{B} prompt {PROMPT} new {NEW}: {wall:.3f} s, tokens equal phase 4's: {same}, "
          f"launches {counts}")
    check(same, "(a) converted parameters give phase 4's tokens exactly")
    check_launched(counts, path_counts["greedy"], "(a) greedy over converted parameters")
    del converted, tokens
    torch.cuda.empty_cache()

    # (b) the patch itself, on a stand-in module.
    gen = torch.Generator(device="cuda").manual_seed(80)
    x = torch.randn(B, PROMPT, cfg.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    xs = torch.randn(B, HF_DECODE_STEPS, cfg.hidden_size, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    inv_freq = L.rope_inv_freq(cfg, "cuda")
    scale = cfg.head_dim ** -0.5
    errs = {}

    def rope(start, s):
        pos = (start + torch.arange(s, device="cuda")).expand(B, s)
        return L.rope_cos_sin(pos, inv_freq, cfg.dtype)

    def held(name, mod, h, start, mask, cache, kv_length, window, want):
        """One attention_forward call, its attention output (o_proj's input)
        against the fp32 reference on the q / k / v it formed."""
        cos, sin = rope(start, h.shape[1])
        with torch.no_grad():
            (_, none), _, counts = counted_run(torch, kernels, lambda: attention_forward(
                mod, h, position_embeddings=(cos, sin), attention_mask=mask,
                past_key_values=cache))
            s = h.shape[1]
            q = L.apply_rope(mod.q_proj(h).view(B, s, -1, cfg.head_dim).transpose(1, 2), cos, sin)
            q_offset = None if kv_length is None or s == 1 else torch.zeros_like(kv_length)
            ref = attention_reference(q.float(), cache.k.float(), cache.v.float(), scale,
                                      causal=True, kv_length=kv_length, q_offset=q_offset,
                                      window=window)
            got = mod.o_proj.seen.view(B, s, -1, cfg.head_dim).transpose(1, 2)
            e = max_err(got, ref)
        add_counts(hf_counts, counts)
        errs[name] = max(errs.get(name, 0.0), e)
        check(none is None, f"(b) {name}: attention_forward returns (out, None)")
        check(bool(torch.isfinite(got).all()) and e <= BF16_TOL,
              f"(b) {name}: finite, within {BF16_TOL} of the fp32 reference (max|diff| {e:.3e})")
        check_launched(counts, want, f"(b) {name}")

    lengths = torch.tensor(HF_PADDED_LENGTHS, dtype=torch.int32, device="cuda")
    mask = (torch.arange(PROMPT, device="cuda")[None, :] < lengths[:, None]).long()
    decode = {"decode_partials": 1, "decode_combine": 1}
    for window, prefill in ((None, "flash_fwd"), (HF_WINDOW, "flash_fwd_window")):
        mod = stand_in_attention(torch, cfg, params, window)
        tag = "" if window is None else f" window {window}"
        if window is None:
            held("right-padded prefill (B4)", mod, x, 0, mask, GrowingCache(torch.cat), lengths,
                 None, {"flash_chunked": 1})
        cache = GrowingCache(torch.cat)
        held(f"prefill{tag} ({'P' if window is None else 'B2'})", mod, x, 0, None, cache, None,
             window, {prefill: 1})
        for t in range(HF_DECODE_STEPS):
            held(f"decode{tag} (D1 + D2)", mod, xs[:, t:t + 1], PROMPT + t, None, cache, None,
                 window, decode)
        check(cache.k.shape[2] == PROMPT + HF_DECODE_STEPS and cache.k.is_contiguous(),
              "(b) the decode steps read a torch.cat-grown cache")
    for name, e in errs.items():
        print(f"  (b) attention_forward, {name}: max|diff| {e:.3e} vs fp32 reference")
    out["stand_in_max_abs_err"] = errs

    q = torch.randn(B, cfg.num_q_heads, PROMPT, cfg.head_dim, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, cfg.num_kv_heads, PROMPT, cfg.head_dim, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)

    def attend(q, k, v):
        return torch_patch._flash_attention_core(q, k, v, scale, True, None).float() * 2.0

    t0 = time.perf_counter()
    compiled = torch.compile(attend, dynamic=False)
    got, _, counts = counted_run(torch, kernels, lambda: compiled(q, k, v))
    out["compile_s"] = time.perf_counter() - t0
    add_counts(hf_counts, counts)
    with torch.no_grad():
        want = attend(q, k, v)
    e = max_err(got, want)
    print(f"  (b) torch.compile (inductor) of a call of {torch_patch.OP_NAME}: "
          f"{out['compile_s']:.1f} s, max|diff| vs eager {e:.3e}, launches {counts}")
    check(e == 0.0, "(b) the compiled call equals the eager one")
    check_launched(counts, {"flash_fwd": 1}, "(b) compiled call")
    del x, xs, q, k, v, got, want

    # (c) the HF model, where transformers imports.
    try:
        import transformers
    except ImportError as exc:
        print(f"  (c) did not run: transformers does not import here ({exc})")
        out["hf_model"] = f"not run: transformers does not import ({exc})"
        return out
    out["hf_model"] = phase_hf_model(torch, transformers, cfg, params, ids, kernels, hf_counts)
    return out


def phase_hf_model(torch, transformers, cfg, params, ids, kernels, hf_counts):
    """(c): HF `LlamaForCausalLM` at the config's widths holding the main
    path's weights, patched onto the port; the original forward restored."""
    from transformers.models.llama import modeling_llama
    from flash_attention_cute_tpu_torch.interop import patch_llama
    from flash_attention_cute_tpu_torch.models.heads import sequence_classification_forward
    from flash_attention_cute_tpu_torch.models.transformer import forward

    n = cfg.num_layers
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=n,
        num_attention_heads=cfg.num_q_heads, num_key_value_heads=cfg.num_kv_heads,
        max_position_embeddings=cfg.max_position_embeddings, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=False, attn_implementation="eager")
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device("cuda"):
            model = transformers.LlamaForCausalLM(hf_cfg).eval()
    finally:
        torch.set_default_dtype(default)
    model.load_state_dict(hf_state_dict(params, cfg))
    orig = modeling_llama.LlamaAttention.forward
    res = {"transformers": transformers.__version__}
    try:
        patch_llama()
        cache = transformers.DynamicCache()
        steps = []
        for k in kernels.values():
            k.launches = 0
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(input_ids=ids, past_key_values=cache, use_cache=True).logits[:, -1]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append(logits.float())
            tok = logits.argmax(-1)
            tokens = [tok]
            for _ in range(HF_NEW - 1):
                logits = model(input_ids=tok[:, None], past_key_values=cache,
                               use_cache=True).logits[:, -1]
                steps.append(logits.float())
                tok = logits.argmax(-1)
                tokens.append(tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        counts = {name: k.launches for name, k in kernels.items()}
        add_counts(hf_counts, counts)
        res.update(prefill_ms=1e3 * (t1 - t0), decode_ms_per_token=1e3 * (t2 - t1) / (HF_NEW - 1),
                   host_wall_s=t2 - t0, launches={k: c for k, c in counts.items() if c})
        print(f"  (c) transformers {transformers.__version__}: patched LlamaForCausalLM, greedy "
              f"B{B} prompt {PROMPT} new {HF_NEW} over DynamicCache: prefill "
              f"{res['prefill_ms']:.2f} ms, decode {res['decode_ms_per_token']:.2f} ms/token, "
              f"host wall {res['host_wall_s']:.3f} s, launches {res['launches']}")
        check_launched(counts, {"flash_fwd": n, "decode_partials": n * (HF_NEW - 1),
                                "decode_combine": n * (HF_NEW - 1)}, "(c) patched HF greedy")
        tokens = torch.stack(tokens, dim=1)
        with torch.no_grad():
            ref = forward(params, cfg, torch.cat([ids, tokens[:, :-1]], dim=1))[0][:, PROMPT - 1:]
        got = torch.stack(steps, dim=1)
        diff = check_logits(torch, "(c) patched HF teacher-forced vs the port's forward", got, ref)
        share = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(share >= ARGMAX_SHARE_MIN, f"(c) argmax share >= {ARGMAX_SHARE_MIN}")
        res.update(teacher_forced_max_mean=diff, argmax_share=share)
        del logits, steps, got, ref, cache

        gen = torch.Generator(device="cuda").manual_seed(81)
        head = dict(params, score=torch.randn(cfg.hidden_size, 2, generator=gen, device="cuda")
                    .mul_(cfg.hidden_size ** -0.5).to(cfg.dtype))
        kern, _, counts = counted_run(torch, kernels, lambda: sequence_classification_forward(
            head, cfg, ids))
        add_counts(hf_counts, counts)
        plain, _, plain_counts = counted_run(torch, kernels, lambda: sequence_classification_forward(
            head, cfg, ids, plain_attention=True))
        e = max_err(kern, plain)
        print(f"  (c) sequence_classification_forward [B {B}, 2]: kernel route vs plain route "
              f"max|diff| {e:.3e}, launches {counts}")
        check(tuple(kern.shape) == (B, 2) and bool(torch.isfinite(kern).all()),
              "(c) classification logits finite, [B, 2]")
        check(e <= BF16_TOL, f"(c) classification kernel route within {BF16_TOL} of plain")
        check_launched(counts, {"flash_fwd": n}, "(c) classification, kernel route")
        check_launched(plain_counts, {}, "(c) classification, plain route")
        res["classification_max_abs_err"] = e
    finally:
        modeling_llama.LlamaAttention.forward = orig
    del model
    torch.cuda.empty_cache()
    return res

def phase_main_path_int8(torch, cfg, params, ids, bf16_tokens, kernels, counts):
    """Greedy generation over an int8 KV cache: the decode step on the
    kernel route (QA, then B7 + D2) against the plain route over one and the
    same quantized cache, then `greedy_generate(cache_dtype=torch.int8)`
    with its launch counts. Agreement with the bf16 cache is printed, not
    held to a limit: quantization moves the logits by design."""
    import dataclasses
    from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
    from flash_attention_cute_tpu_torch.models.transformer import forward
    from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate

    with torch.no_grad():
        cache = QuantizedKVCache.create(cfg, B, CAPACITY, torch.int8)
        logits, cache = forward(params, cfg, ids, cache=cache, mode="prefill")
        tok = logits[:, -1].argmax(-1)[:, None]
        twin = dataclasses.replace(cache, **{f: getattr(cache, f).clone() for f in (
            "k_values", "k_scales", "v_values", "v_scales")})
        a = forward(params, cfg, tok, cache=cache, mode="decode")[0]
        b = forward(params, cfg, tok, cache=twin, mode="decode", plain_attention=True)[0]
        dense = forward(params, cfg, ids, cache=KVCache.create(cfg, B, CAPACITY), mode="prefill")[1]
        ref16 = forward(params, cfg, tok, cache=dense, mode="decode")[0]
        del cache, twin, dense
    check(bool(torch.isfinite(a).all()), "int8-cache decode logits finite")
    d = (a - b).abs()
    print(f"  teacher-forced int8-cache decode step {tuple(a.shape)}, kernel route (B7) vs "
          f"plain over the same cache: max|diff| {d.max().item():.4f}, mean|diff| "
          f"{d.mean().item():.5f}; argmax agree with the bf16 cache "
          f"{(a.argmax(-1) == ref16.argmax(-1)).float().mean().item():.4f} (not gated)")
    check(d.max().item() <= LOGIT_MAX_TOL and d.mean().item() <= LOGIT_MEAN_TOL,
          f"int8-cache decode logits within max {LOGIT_MAX_TOL} / mean {LOGIT_MEAN_TOL}")
    torch.cuda.empty_cache()

    tokens, wall, launched = counted_run(torch, kernels, lambda: greedy_generate(
        params, cfg, ids, NEW, cache_capacity=CAPACITY, cache_dtype=torch.int8))
    counts.update(launched)
    same = (tokens == bf16_tokens).float().mean().item()
    print(f"  greedy_generate int8 cache B{B} prompt {PROMPT} new {NEW}: {wall:.3f} s, "
          f"launches {counts}; tokens equal to the bf16 cache's at {same:.4f} of positions "
          "(free-running: one flip changes the rest; not gated)")
    check(tuple(tokens.shape) == (B, NEW), "int8 greedy token shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "int8 greedy tokens in vocab")
    n = cfg.num_layers
    check(counts["flash_fwd"] == n, f"P launched once per layer in the int8 prefill ({n})")
    check(counts["quant_decode"] == n * (NEW - 1) == counts["decode_combine"],
          f"B7 and D2 launched {n} x {NEW - 1}")
    check(counts["quant_append"] == n * NEW, f"QA launched {n} x (1 + {NEW - 1})")
    check(counts["decode_partials"] == 0, "no bf16 decode (D1) over the int8 cache")
    return {"greedy_int8_wall_s": wall, "greedy_int8_token_agreement_with_bf16": same}


# Phase 4d: (tree, bits, fused, KV cache dtype) of the two quantized paths.
QUANT_WEIGHT_PATHS = (("int8", 8, False, None), ("int4", 4, True, "int8"))


def quantized_tree(torch, params, name):
    """The int8 tree (unfused) or the fused int4 tree of `params`, quantized
    on the card (deterministic: phase 4d and runs F, G build the same)."""
    from flash_attention_cute_tpu_torch.models.fuse import fuse_projections
    from flash_attention_cute_tpu_torch.models.quantize import quantize_params

    _, bits, fused, _ = next(p for p in QUANT_WEIGHT_PATHS if p[0] == name)
    with torch.no_grad():
        return quantize_params(fuse_projections(params) if fused else params, bits=bits)


def phase_quant_weights(torch, cfg, params, ids, bf16_tokens, kernels, path_counts):
    """Greedy generation with weights quantized on the card: (i) unfused
    int8 over the bf16 cache, (ii) fused int4 over an int8 cache (the JAX
    package's README configuration). For each tree: the teacher-forced
    prefill logits and one decode step against its dequantized bf16 image
    (cuBLAS products; the same cache type), then `greedy_generate` with
    its launch counts, then prefill and decode timed apart. Each tree is
    dropped before the next is built."""
    from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
    from flash_attention_cute_tpu_torch.models.quantize import dequantize_params
    from flash_attention_cute_tpu_torch.models.transformer import forward
    from flash_attention_cute_tpu_torch.runtime.generate import (
        decode_loop,
        greedy_generate,
        prefill,
    )
    from flash_attention_cute_tpu_torch.utils.timing import wall_time_s

    n = cfg.num_layers
    numbers = {}
    for name, bits, fused, cache_name in QUANT_WEIGHT_PATHS:
        cache_dtype = getattr(torch, cache_name) if cache_name else None
        kname = next(k for k, (b, _) in QMM_KERNELS.items() if b == bits)
        per_layer = QMM_KERNELS[kname][1]
        label = f"{'fused ' if fused else ''}{name} weights, {cache_name or 'bf16'} cache"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = quantized_tree(torch, params, name)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        torch.cuda.empty_cache()

        def new_cache():
            if cache_dtype is None:
                return KVCache.create(cfg, B, CAPACITY)
            return QuantizedKVCache.create(cfg, B, CAPACITY, cache_dtype)

        # Teacher forcing: the same prompt and next token through the tree
        # and through its dense image (built one at a time, then dropped).
        diffs = {}
        with torch.no_grad():
            got = forward(tree, cfg, ids, cache=new_cache(), mode="prefill")
            tok = got[0][:, -1].argmax(-1)[:, None]
            got_step = forward(tree, cfg, tok, cache=got[1], mode="decode")[0]
            got = got[0]
            image = dequantize_params(tree)
            want = forward(image, cfg, ids, cache=new_cache(), mode="prefill")
            want_step = forward(image, cfg, tok, cache=want[1], mode="decode")[0]
            want = want[0]
            del image
        for what, a, b in (("prefill", got, want), ("decode step", got_step, want_step)):
            diffs[what] = check_logits(
                torch, f"{label}: teacher-forced {what} vs the dequantized image", a, b)
        del got, want, got_step, want_step
        torch.cuda.empty_cache()

        tokens, wall, counts = counted_run(torch, kernels, lambda: greedy_generate(
            tree, cfg, ids, NEW, cache_capacity=CAPACITY, cache_dtype=cache_dtype))
        path_counts[f"greedy {label}"] = counts
        same = (tokens == bf16_tokens).float().mean().item()
        print(f"  greedy_generate {label}: {wall:.3f} s, launches {counts}; tokens equal to "
              f"the bf16 weights' at {same:.4f} of positions (not gated)")
        check(tuple(tokens.shape) == (B, NEW) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), f"{label}: tokens in vocab")
        want_qmm = NEW * (per_layer * n + 1)
        check(counts[kname] == want_qmm,
              f"{label}: {kname} launched {NEW} forwards x ({per_layer} x {n} + 1) = {want_qmm}")
        check(all(counts[k] == 0 for k in QMM_KERNELS if k != kname),
              f"{label}: no launch of the other weight kernel")
        check(counts["flash_fwd"] == n, f"{label}: P launched once per layer in prefill")
        decode = "quant_decode" if cache_dtype else "decode_partials"
        check(counts[decode] == n * (NEW - 1) == counts["decode_combine"],
              f"{label}: {decode} and D2 launched {n} x {NEW - 1}")

        with torch.no_grad():
            (last, cache), pre_s = wall_time_s(
                lambda: prefill(tree, cfg, ids, CAPACITY, cache_dtype))
            first = last.argmax(-1).to(torch.int32)
            _, dec_s = wall_time_s(lambda: decode_loop(tree, cfg, first, cache, NEW - 1))
            # decode_loop wrote the buffers in place; `cache` still holds the
            # prompt's lengths: profile a few steps from there.
            profile = profile_decode(torch, tree, cfg, cache, first[:, None])
        del cache
        if "device_busy_ms_per_step" in profile:
            profile["decode_device_busy_share"] = (
                profile["device_busy_ms_per_step"] / (1e3 * dec_s / (NEW - 1)))
            profile["top_device_kernels_ms_per_step"] = profile[
                "top_device_kernels_ms_per_step"][:6]
        numbers[f"greedy {label}"] = {
            "quantize_s": quantize_s,
            "weights_gb": tree_bytes(tree) / 1e9,
            "weights_floor_ms_per_token": 1e3 * tree_bytes(tree) / PEAK_BYTES,
            "teacher_forced_max_mean_diff": diffs,
            "greedy_wall_s": wall,
            "prefill_ms": 1e3 * pre_s,
            "decode_ms_per_token": 1e3 * dec_s / (NEW - 1),
            "token_agreement_with_bf16_weights": same,
            **profile,
        }
        del tree
        torch.cuda.empty_cache()
    return numbers


def dense_rows(torch, cfg, randn, flash_fwd, flash_decode):
    """Kernel rows of P at the greedy prefill (B 4, S 512, causal) and of D1
    and D2 at its middle decode step (B 4, every row 512 + 32 keys of 576)
    at `cfg`'s attention widths, with their operations and bytes at its
    head dim, and the decode numbers of D1 + D2 beside one SDPA call."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    # P at the main path's prefill shape.
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = randn(B, hq, PROMPT, d), randn(B, hkv, PROMPT, d), randn(B, hkv, PROMPT, d)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    pairs = PROMPT * (PROMPT + 1) // 2  # visible (query, key) pairs per head
    p_ops = 4 * B * hq * pairs * d
    p_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    rows = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:595",
        "ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True)),
        "call_ms": call_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True)),
        "plain_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True), 5),
        "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(q, kr, vr, is_causal=True)),
        "ops": p_ops, "bytes": p_bytes, "peak": PEAK_BF16,
    }]

    # D1 and D2 at the middle decode step: every row holds 512 + 32 keys.
    kc, vc = randn(B, hkv, CAPACITY, d), randn(B, hkv, CAPACITY, d)
    qd = randn(B, hq, 1, d)
    live = PROMPT + NEW // 2
    lengths = torch.full((B,), live, dtype=torch.int32, device="cuda")
    splits = dispatch.decode_num_splits(B, hkv, CAPACITY, d)
    scale = d ** -0.5
    acc, m, l = flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits)
    part_bytes = 4 * (acc.numel() + m.numel() + l.numel())
    # The whole decode attention, D1 + D2, beside one SDPA call over the
    # length-masked cache: D1's library time (no call computes partials).
    mask = (torch.arange(CAPACITY, device="cuda") < live)[None, None, None, :]
    kcr, vcr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kc, vc))
    dec_ms = cuda_time_ms(lambda: flash_decode.flash_attention_decode(qd, kc, vc, lengths), 50)
    dec_call_ms = call_time_ms(lambda: flash_decode.flash_attention_decode(qd, kc, vc, lengths), 50)
    sdpa_dec_ms = cuda_time_ms(lambda: f.scaled_dot_product_attention(qd, kcr, vcr, attn_mask=mask), 50)
    del kcr, vcr
    rows.append({
        "name": "decode_partials", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_decode.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_decode.py:42",
        "ms": cuda_time_ms(lambda: flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits), 50),
        "call_ms": call_time_ms(lambda: flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits), 50),
        "plain_ms": cuda_time_ms(lambda: flash_decode.decode_partials_plain(qd, kc, vc, lengths, scale, splits), 10),
        "library_ms": sdpa_dec_ms, "with_combine_ms": dec_ms,
        "library_of": LIBRARY_OF_D1,
        # As B5 / B8's rows: operations at the bf16 tensor peak, the split
        # partials not counted.
        "ops": 4 * B * hq * live * d,
        "bytes": 2 * qd.numel() + 2 * 2 * B * hkv * live * d + 4 * B,
        "peak": PEAK_BF16,
    })
    rows.append({
        "name": "decode_combine", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_decode.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_decode.py:345",
        "ms": cuda_time_ms(lambda: flash_decode.decode_combine(acc, m, l, torch.bfloat16), 50),
        "call_ms": call_time_ms(lambda: flash_decode.decode_combine(acc, m, l, torch.bfloat16), 50),
        "plain_ms": cuda_time_ms(lambda: flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16), 10),
        "library_ms": None,  # no single PyTorch call merges split partials
        "ops": 4 * acc.numel(), "bytes": part_bytes + 2 * qd.numel(), "peak": PEAK_F32,
    })
    return rows, {"decode_attention_ms": dec_ms, "decode_attention_call_ms": dec_call_ms,
                  "decode_attention_sdpa_ms": sdpa_dec_ms, "decode_num_splits": splits}


def phase_numbers(torch, cfg, params, ids, flash_fwd, flash_decode):
    from flash_attention_cute_tpu_torch.runtime.generate import decode_loop, prefill
    from flash_attention_cute_tpu_torch.utils.timing import wall_time_s

    gen = torch.Generator(device="cuda").manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows, decode_numbers = dense_rows(torch, cfg, randn, flash_fwd, flash_decode)
    rows += chunked_rows(torch, cfg, gen)
    rows += paged_rows(torch, cfg, randn, gen)
    rows += quant_rows(torch, cfg, randn, gen)
    rows += qmm_rows(torch, cfg, gen)

    for r in rows:
        r.update(bound(r.pop("ops"), r.pop("bytes"), r.pop("peak")))

    # Main-path phases on the host clock, each ending in a synchronise.
    with torch.no_grad():
        (last, cache), pre_s = wall_time_s(lambda: prefill(params, cfg, ids, CAPACITY))
        first = last.argmax(-1).to(torch.int32)
        _, dec_s = wall_time_s(lambda: decode_loop(params, cfg, first, cache, NEW - 1))
        # decode_loop wrote the buffers in place but `cache` still holds the
        # prompt's lengths: profile a few steps from there.
        profile = profile_decode(torch, params, cfg, cache, first[:, None])
    weight_bytes = tree_bytes(params)
    return rows, {
        "prefill_ms": 1e3 * pre_s,
        "prefill_tokens_per_s": B * PROMPT / pre_s,
        "decode_ms_per_token": 1e3 * dec_s / (NEW - 1),
        "decode_device_busy_share": (
            profile["device_busy_ms_per_step"] / (1e3 * dec_s / (NEW - 1))
            if "device_busy_ms_per_step" in profile else None),
        "decode_tokens_per_s": B * (NEW - 1) / dec_s,
        "weights_gb": weight_bytes / 1e9,
        "weights_floor_ms_per_token": 1e3 * weight_bytes / PEAK_BYTES,
        **decode_numbers,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "layers": cfg.num_layers,
    }, profile


def kernel_entries(rows, errs, path_counts) -> list:
    """The `kernels` JSON line: each row with its launches on every main
    path (the counts of its path runs) and its largest error against its
    plain version over the whole script."""
    def share_of_bound(entry):  # each timed shape's share of its bound, nested ones too
        if entry.get("ms") and entry.get("bound_ms"):
            entry["of_bound"] = entry["bound_ms"] / entry["ms"]
        for key in ("chunk", "window", "gemma2", "long", "phi3", "g16", "m71", "zigzag_step",
                    "o", "v4", "verify", "page64", "e4m3", "b6"):
            if isinstance(entry.get(key), dict):
                share_of_bound(entry[key])

    out = []
    for r in rows:
        share_of_bound(r)
        by_path = {path: c[r["name"]] for path, c in path_counts.items()}
        out.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "of_bound": r.get("of_bound"),
            "shape": r.get("shape", "the main path's"),
            **{key: r[key] for key in ("library_of", "with_combine_ms", "prefill", "chunk",
                                       "window", "lse", "max_rel_err", "gemma2", "projections",
                                       "runtime_attributes", "with_k8_ms", "bf16_ms", "long",
                                       "oracle_max_abs_err", "phi3", "g16", "m71",
                                       "zigzag_step", "sequence_parallel", "o", "v4")
               if key in r},
        })
    return out


def paged_rows(torch, cfg, randn, gen):
    """Kernel rows of B5 (+ D2), B6 and the paged append at the serving
    runs' shapes: B5 at run A's decode (8 slots, page_size 128, the first 8
    requests 32 tokens into their generation), B6 at run B's extend (8
    rows, chunk 256, page_size 16, offsets 0-768), the append at run A's
    decode (8 rows, one token each)."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.ops import paged_attention as pa
    from flash_attention_cute_tpu_torch.runtime import paged_cache
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    rep = hq // hkv
    rows = []

    def pool(b, ps, pps):
        kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=pps * ps, layers=1,
                                   d=d, hkv=hkv)
        return kp[0], vp[0], table

    # B5 + D2: the whole paged decode call.
    b, ps, pps = 8, 128, 16
    kp, vp, table = pool(b, ps, pps)
    lens_list = [len(p) + 32 for _, p, _ in serving_requests(cfg)[:b]]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    q = randn(b, hq, 1, d)
    live = sum(lens_list)
    splits = dispatch.decode_num_splits(b, hkv, pps * ps, d)
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    rows.append({
        "name": "paged_decode", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flash_attention_cute_tpu/ops/paged_attention.py:85",
        "ms": cuda_time_ms(lambda: pa.paged_attention_decode(q, kp, vp, lens, table), 50),
        "call_ms": call_time_ms(lambda: pa.paged_attention_decode(q, kp, vp, lens, table), 50),
        "plain_ms": cuda_time_ms(lambda: pa.paged_attention_decode_plain(q, kp, vp, lens, table), 10),
        "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=mask), 50),
        "ops": 4 * hq * live * d,  # `live` already sums the rows' keys
        "bytes": (2 * q.numel() + 2 * 2 * hkv * live * d
                  + 4 * (b + sum(-(-n // ps) for n in lens_list)) + 2 * q.numel()),
        "peak": PEAK_BF16,
        "shape": f"B {b}, page_size {ps}, lengths {lens_list}, splits {splits}; ms includes D2",
    })
    del kp, vp, kc, vc

    # B6 at run B's extend.
    b, ps, pps, s = 8, 16, 128, 256
    kp, vp, table = pool(b, ps, pps)
    offs = [0, 256, 512, 768] * 2
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl = off + s
    q = randn(b, s, hq, d).transpose(1, 2)
    pairs = sum(s * o + s * (s + 1) // 2 for o in offs)
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    cols = torch.arange(pps * ps, device="cuda")[None, None, :]
    mask = ((cols <= off[:, None, None] + torch.arange(s, device="cuda")[None, :, None])
            & (cols < kvl[:, None, None]))[:, None]
    rows.append({
        "name": "paged_extend", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/paged_extend.cuh",
        "replaces": "flash_attention_cute_tpu/ops/paged_attention.py:391",
        "ms": cuda_time_ms(lambda: pa.paged_attention_extend(q, kp, vp, off, kvl, table)),
        "call_ms": call_time_ms(lambda: pa.paged_attention_extend(q, kp, vp, off, kvl, table)),
        "plain_ms": cuda_time_ms(lambda: pa.paged_attention_extend_plain(q, kp, vp, off, kvl, table), 5),
        "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)),
        "ops": 4 * hq * d * pairs,
        "bytes": (2 * 2 * q.numel() + 2 * 2 * hkv * d * int(kvl.sum())
                  + 4 * (2 * b + sum(-(-int(n) // ps) for n in kvl.tolist()))),
        "peak": PEAK_BF16,
        "shape": f"B {b}, S {s}, page_size {ps}, q_offset {offs}",
    })
    del kp, vp, kc, vc, mask

    # The append at run A's decode: one token per row into a page_size 128 pool.
    b, ps, pps = 8, 128, 16
    kp, vp, table = pool(b, ps, pps)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    nk, nv = randn(b, 1, hkv, d).transpose(1, 2), randn(b, 1, hkv, d).transpose(1, 2)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    flat, _ = paged_cache.append_targets(table, lens, 1, ps)
    flat = flat.view(-1)
    kflat, vflat = (flat_pool(x) for x in (kp, vp))
    krows, vrows = (x.permute(1, 0, 2, 3).reshape(hkv, b, d) for x in (nk, nv))

    def library_append():
        kflat.index_copy_(1, flat, krows)
        vflat.index_copy_(1, flat, vrows)

    rows.append({
        "name": "paged_append", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flash_attention_cute_tpu/runtime/paged_cache.py:130",
        "ms": cuda_time_ms(lambda: paged_cache.paged_append_layer(kp, vp, nk, nv, table, lens, active), 50),
        "call_ms": call_time_ms(lambda: paged_cache.paged_append_layer(kp, vp, nk, nv, table, lens, active), 50),
        "plain_ms": cuda_time_ms(lambda: paged_cache.paged_append_layer_plain(kp, vp, nk, nv, table, lens, active), 10),
        "library_ms": cuda_time_ms(library_append, 50),
        "ops": 0,
        "bytes": 2 * 2 * 2 * nk.numel() + 4 * 3 * b,
        "peak": PEAK_F32,
        "shape": f"B {b}, S 1, page_size {ps}; library_ms is index_copy_ on K and on V",
    })
    return rows


def quant_rows(torch, cfg, randn, gen):
    """Kernel rows of B7 (+ D2) at the int8 greedy path's middle decode step
    (B 4, cache 576, every row 544 keys), B8 (+ D2) at run D's decode (8
    slots, page_size 128, the first 8 requests 32 tokens into their
    generation, int8), B9 at run E's extend (8 rows, chunk 256, page_size
    16, offsets 0-768, e4m3) and QA at run D's decode (8 rows, one token,
    int8 pages). `library_ms` of B7-B9 is one SDPA call over a dequantized
    bf16 contiguous copy of the keys (GQA expanded, masked), whose
    dequantization is not timed; no single PyTorch call quantizes, so QA
    has none."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.ops import quantized as qz
    from flash_attention_cute_tpu_torch.ops.paged_attention import append_targets
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    rep = hq // hkv
    src = "flash_attention_cute_tpu_torch/csrc/quantized.cu"
    rows = []

    def dense_copy(kv, table=None):
        """bf16 keys [B, Hq, n, D] for the library call (not timed)."""
        x = qz._gather_dequantized(kv, table) if table is not None else qz.dequantize_kv(kv)
        return x.to(torch.bfloat16).repeat_interleave(rep, dim=1)

    def timed(fn, plain, library, iters=50):
        return {"ms": cuda_time_ms(fn, iters), "call_ms": call_time_ms(fn, iters),
                "plain_ms": cuda_time_ms(plain, 10),
                "library_ms": None if library is None else cuda_time_ms(library, iters)}

    # B7 + D2.
    b, cap, live = B, CAPACITY, PROMPT + NEW // 2
    k, v = (qz.quantize_kv(randn(b, hkv, cap, d), torch.int8) for _ in "kv")
    k, v = (qz.QuantizedKV(pitched(torch, x.values), x.scales) for x in (k, v))
    q = randn(b, hq, 1, d)
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    splits = dispatch.decode_num_splits(b, hkv, cap, d)
    kc, vc = dense_copy(k), dense_copy(v)
    mask = (torch.arange(cap, device="cuda") < live)[None, None, None, :]
    rows.append({
        "name": "quant_decode", "route": "cuda", "source": src,
        "replaces": "flash_attention_cute_tpu/ops/quantized.py:73",
        **timed(lambda: qz.flash_attention_decode_quantized(q, k, v, lengths),
                lambda: qz.flash_attention_decode_quantized_plain(q, k, v, lengths),
                lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)),
        "ops": 4 * b * hq * live * d,
        "bytes": (2 * q.numel() + 2 * b * hkv * live * d + 2 * 4 * b * hkv * live + 4 * b
                  + 2 * q.numel()),
        "peak": PEAK_BF16,
        "shape": f"B {b}, cache {cap}, lengths {live}, int8, splits {splits}; ms includes D2",
    })
    del k, v, kc, vc

    # B8 + D2 at run D's decode.
    b, ps, pps = 8, 128, 16
    k, v, table = quant_pool(torch, qz, randn, gen, ps, b, torch.int8, d=d, hkv=hkv)
    lens_list = [len(p) + 32 for _, p, _ in serving_requests(cfg)[:b]]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    q = randn(b, hq, 1, d)
    live = sum(lens_list)
    splits = dispatch.decode_num_splits(b, hkv, pps * ps, d)
    kc, vc = dense_copy(k, table), dense_copy(v, table)
    mask = (torch.arange(pps * ps, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    rows.append({
        "name": "quant_paged_decode", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/quant_paged_decode.cu",
        "replaces": "flash_attention_cute_tpu/ops/quantized.py:395",
        **timed(lambda: qz.paged_attention_decode_quantized(q, k, v, lens, table),
                lambda: qz.paged_attention_decode_quantized_plain(q, k, v, lens, table),
                lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)),
        "ops": 4 * hq * live * d,  # `live` already sums the rows' keys
        "bytes": (2 * q.numel() + 2 * hkv * live * d + 2 * 4 * hkv * live
                  + 4 * (b + sum(-(-n // ps) for n in lens_list)) + 2 * q.numel()),
        "peak": PEAK_BF16,
        "shape": f"B {b}, page_size {ps}, lengths {lens_list}, int8, splits {splits}; "
                 "ms includes D2",
    })
    del k, v, kc, vc

    # B9 at run E's extend.
    b, ps, pps, s = 8, 16, 128, 256
    k, v, table = quant_pool(torch, qz, randn, gen, ps, b, torch.float8_e4m3fn, d=d,
                          hkv=hkv)
    offs = [0, 256, 512, 768] * 2
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl = off + s
    q = randn(b, s, hq, d).transpose(1, 2)
    pairs = sum(s * o + s * (s + 1) // 2 for o in offs)
    kc, vc = dense_copy(k, table), dense_copy(v, table)
    cols = torch.arange(pps * ps, device="cuda")[None, None, :]
    mask = ((cols <= off[:, None, None] + torch.arange(s, device="cuda")[None, :, None])
            & (cols < kvl[:, None, None]))[:, None]
    kv_tokens = int(kvl.sum())
    rows.append({
        "name": "quant_paged_extend", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/paged_extend.cuh",
        "replaces": "flash_attention_cute_tpu/ops/quantized.py:717",
        **timed(lambda: qz.paged_attention_extend_quantized(q, k, v, off, kvl, table),
                lambda: qz.paged_attention_extend_quantized_plain(q, k, v, off, kvl, table),
                lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=mask), 20),
        "ops": 4 * hq * d * pairs,
        "bytes": (2 * 2 * q.numel() + 2 * hkv * d * kv_tokens + 2 * 4 * hkv * kv_tokens
                  + 4 * (2 * b + sum(-(-int(n) // ps) for n in kvl.tolist()))),
        "peak": PEAK_BF16,
        "shape": f"B {b}, S {s}, page_size {ps}, q_offset {offs}, e4m3",
    })
    del k, v, kc, vc, mask

    # QA at run D's decode: one token per row into int8 pages of 128.
    b, ps, pps = 8, 128, 16
    k, v, table = quant_pool(torch, qz, randn, gen, ps, b, torch.int8, d=d, hkv=hkv)
    nk, nv = (randn(b, 1, hkv, d).transpose(1, 2) for _ in "kv")
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    assert bool(append_targets(table, lens, 1, ps)[1].all())  # every row writes
    rows.append({
        "name": "quant_append", "route": "cuda", "source": src,
        "replaces": "flash_attention_cute_tpu/runtime/paged_cache.py:206",
        **timed(lambda: qz.quantize_append(nk, nv, k, v, lens, table, active),
                lambda: qz.quantize_append_plain(nk, nv, k, v, lens, table, active), None),
        "ops": 3 * 2 * nk.numel(),  # |x| and max, x / scale, the rounding
        "bytes": 2 * 2 * nk.numel() + 2 * nk.numel() + 2 * 4 * b * hkv + 4 * 3 * b,
        "peak": PEAK_F32,
        "shape": f"B {b}, S 1, page_size {ps}, int8; library_ms null: no single PyTorch "
                 "call quantizes",
    })
    return rows


def chunked_rows(torch, cfg, gen):
    """Kernel row of B4 at the verify shape of phase 4e's last round (B 4,
    S gamma + 1 = 5, the default capacity 582, q_offset 571, kv_length 576:
    bound by the bytes of the live K/V) and, under "chunk", at phase 3d's
    chunk (S 256, q_offset 0 / 77 / 300 / 768, capacity 1100: bound by
    operations). `library_ms` is one SDPA call over the contiguous cache
    with the causal-offset and length mask, GQA expanded (the expansion and
    the mask are not timed)."""
    from flash_attention_cute_tpu_torch.ops import flash_chunked as fc
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim

    def measure(s, cap, offs, iters):
        q, k, v, off, kvl = chunked_inputs(torch, gen, torch.bfloat16, s, cap, offs, None, d,
                                           hq, hkv)
        kr, vr = (x.nan_to_num().repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        cols = torch.arange(cap, device="cuda")[None, None, :]
        mask = ((cols <= off[:, None, None] + torch.arange(s, device="cuda")[None, :, None])
                & (cols < kvl[:, None, None]))[:, None]
        pairs = sum(s * o + s * (s + 1) // 2 for o in offs)  # visible (query, key) pairs
        live = sum(o + s for o in offs)  # keys read once
        row = {
            "shape": f"B {len(offs)}, S {s}, capacity {cap}, q_offset {offs}; library_ms: "
                     "SDPA over the contiguous cache, causal-offset + length mask, GQA "
                     "expanded",
            "ms": cuda_time_ms(lambda: fc.flash_attention_chunked(q, k, v, off, kvl), iters),
            "call_ms": call_time_ms(lambda: fc.flash_attention_chunked(q, k, v, off, kvl), iters),
            "plain_ms": cuda_time_ms(
                lambda: fc.flash_attention_chunked_plain(q, k, v, off, kvl), 5),
            "library_ms": cuda_time_ms(
                lambda: f.scaled_dot_product_attention(q, kr, vr, attn_mask=mask), iters),
        }
        ops = 4 * hq * d * pairs
        nbytes = 2 * 2 * q.numel() + 2 * 2 * hkv * d * live + 2 * 4 * len(offs)
        return row, ops, nbytes

    row, ops, nbytes = measure(GAMMA + 1, PROMPT + NEW + GAMMA + 2, [PROMPT + NEW - GAMMA - 1] * B,
                               50)
    chunk, c_ops, c_bytes = measure(256, 1100, [0, 77, 300, 768], 20)
    chunk.update(bound(c_ops, c_bytes, PEAK_BF16))
    return [{
        "name": "flash_chunked", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_chunked.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_chunked.py:47",
        **row, "ops": ops, "bytes": nbytes, "peak": PEAK_BF16, "chunk": chunk,
    }]


# Phases 4f / 4g: Mistral-7B (a window of 4096 on every layer) and
# Qwen2-7B (QKV biases, GQA group 7) at full width.
MISTRAL_B, MISTRAL_PROMPT, MISTRAL_NEW, WINDOW = 2, 5120, 32, 4096
MISTRAL_CAPACITY = MISTRAL_PROMPT + MISTRAL_NEW
QWEN2_B, QWEN2_PROMPT, QWEN2_NEW = 4, 512, 32
MISTRAL_SERVING_RUNS = {
    "M1 whole-prompt": dict(slots=4, page_size=128, pages_per_seq=40, num_pages=161,
                            prefill_group=4, decode_chunk=8),
    "M2 chunked": dict(slots=4, page_size=16, pages_per_seq=315, num_pages=1261,
                       prefill_chunk=512),
}


def mistral_requests(vocab_size):
    """8 requests: prompt lengths uniform in 4200-5000 (past the window),
    max_new_tokens in 16-32, ids uniform over the vocabulary, all from
    numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(4200, 5001, 8)
    news = rng.integers(16, 33, 8)
    return [(rid, rng.integers(0, vocab_size, int(n)).tolist(), int(m))
            for rid, (n, m) in enumerate(zip(plens, news))]


def forward_pair(torch, cfg, params, ids, capacity, plain, tok=None, keep=None):
    """(prefill logits, logits of one decode step, the step's tokens): a
    prefill of `ids` into a bf16 cache, then a decode step of `tok` (default:
    each row's greedy next token). The plain route runs one batch row at a
    time: its fp32 scores of a 5120-token prompt take 3.4 GB a row. With
    `keep` (prefill positions) both routes run a row at a time and keep
    only those positions' logits: at Gemma2's vocabulary of 256000 one
    4608-token row of fp32 logits is 4.7 GB."""
    from flash_attention_cute_tpu_torch.models.cache import KVCache
    from flash_attention_cute_tpu_torch.models.transformer import forward

    rows = plain or keep is not None
    groups = [slice(i, i + 1) for i in range(ids.shape[0])] if rows else [slice(None)]
    pre, step, toks = [], [], []
    with torch.no_grad():
        for g in groups:
            cache = KVCache.create(cfg, ids[g].shape[0], capacity)
            logits, cache = forward(params, cfg, ids[g], cache=cache, plain_attention=plain)
            t = logits[:, -1].argmax(-1)[:, None] if tok is None else tok[g]
            pre.append(logits if keep is None else logits[:, keep])
            step.append(forward(params, cfg, t, cache=cache, mode="decode",
                                plain_attention=plain)[0])
            toks.append(t)
            del cache, logits
    return torch.cat(pre), torch.cat(step), torch.cat(toks)


def check_counts(counts, want, what):
    """Every kernel launched exactly `want[name]` times (0 if absent)."""
    for name, c in counts.items():
        check(c == want.get(name, 0),
              f"({what}) {name} launched {want.get(name, 0)} times, got {c}")


def prefill_counts(cfg, prompt):
    """Launches of one prefill forward of `prompt` tokens: B2 on each layer
    whose window binds (W < prompt), P on every other layer."""
    win = sum(1 for li in range(cfg.num_layers) if (cfg.layer_window(li) or prompt) < prompt)
    return {"flash_fwd_window": win, "flash_fwd": cfg.num_layers - win}


def phase_family(torch, cfg, params, seed, b, prompt, new, kernels, path_counts, label,
                 keep=None):
    """Teacher-forced prefill and decode-step logits of the kernel route
    against the plain_attention route (at the prefill positions `keep`, if
    given), then `greedy_generate` over a bf16 cache with its launch counts
    (prefill: B2 on each layer whose window binds, else P; D1 + D2 per layer
    and decode step)."""
    import numpy as np
    from flash_attention_cute_tpu_torch.runtime.generate import decode_loop, greedy_generate, prefill
    from flash_attention_cute_tpu_torch.utils.timing import wall_time_s

    n = cfg.num_layers
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, prompt)))
    ids = ids.to("cuda")
    pre_p, step_p, tok = forward_pair(torch, cfg, params, ids, prompt + new, True, keep=keep)
    pre_k, step_k, _ = forward_pair(torch, cfg, params, ids, prompt + new, False, tok, keep)
    diffs = {"prefill": check_logits(torch, f"{label} teacher-forced prefill, kernel vs plain",
                                     pre_k, pre_p),
             "decode step": check_logits(torch, f"{label} teacher-forced decode step, kernel vs "
                                         "plain", step_k, step_p)}
    del pre_p, pre_k, step_p, step_k
    torch.cuda.empty_cache()
    tokens, wall, counts = counted_run(torch, kernels, lambda: greedy_generate(
        params, cfg, ids, new, cache_capacity=prompt + new))
    path_counts[f"{label} greedy"] = counts
    print(f"  {label} greedy_generate B{b} prompt {prompt} new {new}: {wall:.3f} s, launches "
          f"{ {k: c for k, c in counts.items() if c} }")
    check(tuple(tokens.shape) == (b, new) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), f"{label}: tokens in vocab")
    check_counts(counts, {**prefill_counts(cfg, prompt), "decode_partials": n * (new - 1),
                          "decode_combine": n * (new - 1)}, f"{label} greedy")
    # Prefill and decode apart, on the host clock (not a counted path).
    with torch.no_grad():
        (last, cache), pre_s = wall_time_s(lambda: prefill(params, cfg, ids, prompt + new))
        first = last.argmax(-1).to(torch.int32)
        _, dec_s = wall_time_s(lambda: decode_loop(params, cfg, first, cache, new - 1))
    del cache, last
    torch.cuda.empty_cache()
    print(f"  {label} prefill B{b} x {prompt}: {1e3 * pre_s:.1f} ms; decode "
          f"{1e3 * dec_s / (new - 1):.2f} ms/token")
    return ids, tokens, {"teacher_forced_max_mean_diff": diffs, "greedy_wall_s": wall,
                         "greedy_tokens_per_s": b * new / wall, "prefill_ms": 1e3 * pre_s,
                         "prefill_tokens_per_s": b * prompt / pre_s,
                         "decode_ms_per_token": 1e3 * dec_s / (new - 1)}


def phase_mistral(torch, cfg, params, kernels, path_counts):
    """Mistral-7B: teacher forcing and greedy generation (B2 prefills; D1 +
    D2 over a bf16 cache, QA and B7 + D2 over an int8 cache), then the
    serving engine in runs M1 (whole-prompt admission: B2, B5 + D2, the
    append) and M2 (chunked admission: B6, B5 + D2), every token
    teacher-forced through one contiguous prefill (B2)."""
    label = "Mistral-7B"
    ids, _, results = phase_family(torch, cfg, params, 7, MISTRAL_B, MISTRAL_PROMPT,
                                   MISTRAL_NEW, kernels, path_counts, label)

    results.update(quantized_greedy(torch, cfg, params, ids, MISTRAL_NEW, kernels,
                                    path_counts, label, ("int8",)))
    results.update(serve_long_requests(torch, cfg, params, kernels, path_counts, label,
                                       MISTRAL_SERVING_RUNS))
    return results


def quantized_greedy(torch, cfg, params, ids, new, kernels, path_counts, label, values):
    """Over a cache of each value type of `values`: the decode step after
    the prefill of `ids` over one and the same cache, kernel route (QA, B7 +
    D2) against the plain route; then `greedy_generate` of `new` tokens with
    its exact launch counts: the prefill's, QA layers x new, B7 and D2
    layers x (new - 1)."""
    import dataclasses
    from flash_attention_cute_tpu_torch.models.transformer import forward
    from flash_attention_cute_tpu_torch.runtime.generate import greedy_generate, prefill

    n, prompt = cfg.num_layers, ids.shape[1]
    results = {}
    for vname in values:
        dtype, short = getattr(torch, vname), vname.replace("float8_e4m3fn", "e4m3")
        with torch.no_grad():
            last, cache = prefill(params, cfg, ids, prompt + new, dtype)
            tok = last.argmax(-1)[:, None]
            del last
            twin = dataclasses.replace(cache, **{f: getattr(cache, f).clone() for f in (
                "k_values", "k_scales", "v_values", "v_scales")})
            a = forward(params, cfg, tok, cache=cache, mode="decode")[0]
            b = forward(params, cfg, tok, cache=twin, mode="decode", plain_attention=True)[0]
            del cache, twin
        results[f"{short}_decode_step_max_mean_diff"] = check_logits(
            torch, f"{label} {short}-cache decode step, kernel route (B7) vs plain", a, b)
        del a, b
        tokens, wall, counts = counted_run(torch, kernels, lambda: greedy_generate(
            params, cfg, ids, new, cache_capacity=prompt + new, cache_dtype=dtype))
        path_counts[f"{label} greedy {short}"] = counts
        print(f"  {label} greedy_generate {short} cache: {wall:.3f} s, launches "
              f"{ {k: c for k, c in counts.items() if c} }")
        check(tuple(tokens.shape) == (ids.shape[0], new) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), f"{label} {short}: tokens")
        check_counts(counts, {**prefill_counts(cfg, prompt), "quant_append": n * new,
                              "quant_decode": n * (new - 1), "decode_combine": n * (new - 1)},
                     f"{label} greedy {short}")
        results[f"greedy_{short}_wall_s"] = wall
        torch.cuda.empty_cache()
    return results


def serve_long_requests(torch, cfg, params, kernels, path_counts, label, runs, reqs=None):
    """The serving engine over `reqs` (default `mistral_requests`: 8 prompts
    of 4200-5000 tokens, past every window) in each run of `runs` (name ->
    engine options; a `kv_dtype` name takes quantized pages): every request
    finishes, launch counts match the forwards (a prefill forward runs
    `prefill_counts` at its padded length, an extend B6 or B9, a decode B5
    or B8 + D2, every forward the append or QA, per layer), and every token
    is teacher-forced: through one contiguous prefill, or over quantized
    pages through `teacher_forced_paged` as the run admitted it."""
    from flash_attention_cute_tpu_torch.runtime.engine import ServingEngine

    n, results = cfg.num_layers, {}
    reqs = reqs or mistral_requests(cfg.vocab_size)
    per_prefill = prefill_counts(cfg, min(len(p) for _, p, _ in reqs))
    for name, kw in runs.items():
        quant = "kv_dtype" in kw
        if quant:
            kw = {**kw, "kv_dtype": getattr(torch, kw["kv_dtype"])}
        dec, ext, app = QUANT_SERVING if quant else DENSE_SERVING
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(params, cfg, **kw)
        pool_bytes = sum(t.numel() * t.element_size() for f, t in vars(eng.state).items()
                         if f not in ("page_table", "lengths"))
        for rid, prompt, new in reqs:
            eng.submit(rid, prompt, new)
        out, wall, counts = counted_run(torch, kernels, eng.run)
        peak = torch.cuda.max_memory_allocated()
        path_counts[f"{label} {name}"] = counts
        fw = eng.forwards
        print(f"  ({label} {name}) {kw}: {wall:.3f} s, forwards {fw}, launches "
              f"{ {k: c for k, c in counts.items() if c} }, stats {eng.stats}; pool "
              f"{pool_bytes / 1e9:.4f} GB, peak memory {peak / 1e9:.3f} GB")
        check(sorted(out) == list(range(len(reqs))) and not eng.failed,
              f"({name}) every request finishes, none fails")
        check_counts(counts, {**{k: c * fw["prefill"] for k, c in per_prefill.items()},
                              ext: n * fw["extend"], dec: n * fw["decode"],
                              "decode_combine": n * fw["decode"],
                              app: n * sum(fw.values())}, f"{label} {name}")
        if kw.get("prefill_chunk"):
            check(fw["extend"] > 0, f"({name}) admission by extend")
        else:
            check(fw["prefill"] > 0 and fw["extend"] == 0, f"({name}) admission by prefill")
        near, top = [], []
        tf_state = quantized_tf_state(torch, cfg, kw) if quant else None
        for rid, prompt, _ in reqs:
            if quant:
                x, y = teacher_forced_paged(torch, cfg, params, tf_state, prompt, out[rid],
                                            kw.get("prefill_chunk", 0))
            else:
                x, y = teacher_forced(torch, cfg, params, prompt, out[rid])
            near += x
            top += y
        del tf_state
        print(f"  ({label} {name}) teacher-forced: {sum(near)}/{len(near)} tokens within "
              f"{LOGIT_MAX_TOL} of the top logit, argmax share {sum(top) / len(top):.4f}")
        check(all(near), f"({name}) every engine token within {LOGIT_MAX_TOL} of the top logit")
        check(sum(top) / len(top) >= ARGMAX_SHARE_MIN,
              f"({name}) argmax share of the engine tokens >= {ARGMAX_SHARE_MIN}")
        ttft = sorted(m["ttft_s"] for m in eng.request_metrics)
        gen_tokens = eng.stats["tokens_generated"]
        results[name] = {
            "wall_s": wall, "generated_tokens": gen_tokens,
            "generated_tokens_per_s": gen_tokens / wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p90_s": ttft[int(0.9 * (len(ttft) - 1))],
            "decode_rounds": eng.decode_rounds,
            "decode_ms_per_round": 1e3 * eng.decode_round_s / max(eng.decode_rounds, 1),
            "prefills": eng.stats["prefills"], "forwards": dict(fw),
            "teacher_forced_argmax_share": sum(top) / len(top),
            "pool_gb": pool_bytes / 1e9, "peak_memory_gb": peak / 1e9,
        }
        del eng, out
        torch.cuda.empty_cache()
    return results


def phase_qwen2(torch, cfg, params, kernels, path_counts):
    """Qwen2-7B with non-zero q/k/v biases: teacher forcing and greedy
    generation (P, D1 + D2 at GQA group 7)."""
    biases = [params["layers"][k] for k in ("q_bias", "k_bias", "v_bias")]
    check(all(bool((x != 0).any()) for x in biases), "Qwen2-7B: non-zero q/k/v biases")
    return phase_family(torch, cfg, params, 8, QWEN2_B, QWEN2_PROMPT, QWEN2_NEW, kernels,
                        path_counts, "Qwen2-7B")[2]


def window_rows(torch, ops, gen):
    """The kernel row of B2 at Mistral-7B's greedy prefill (B 2, S 5120,
    W 4096; library_ms: SDPA with the causal window as a boolean mask, GQA
    expanded), and the `window` entries of the D1, B4, B5, B6, B7, B8 and
    B9 rows: each kernel with W 4096 at a Mistral-7B shape past the window
    (library_ms: one SDPA call with the window in the boolean mask over a
    contiguous, dequantized bf16 copy where the kernel reads pages or
    quantized values; the copy is not timed). Bounds count the keys the
    window leaves visible."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    flash_fwd, flash_decode = ops["flash_fwd"], ops["flash_decode"]
    flash_chunked = ops["flash_chunked"]
    pa, qz = ops["paged_attention"], ops["quantized"]
    f = torch.nn.functional
    hq, hkv, d, w = 32, 8, 128, WINDOW
    rep = hq // hkv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def measure(fn, plain, library, ops_, nbytes, peak, shape, iters=20, plain_iters=5):
        return {"shape": shape, "ms": cuda_time_ms(fn, iters), "call_ms": call_time_ms(fn, iters),
                "plain_ms": cuda_time_ms(plain, plain_iters),
                "library_ms": None if library is None else cuda_time_ms(library, iters),
                "ops": ops_, "bytes": nbytes, "peak": peak}

    def visible_pairs(offsets, s):
        """(query, key) pairs a causal window leaves visible, summed over
        the batch rows (one offset each): the query at global position p
        sees min(p + 1, W) keys."""
        return sum(min(o + r + 1, w) for o in offsets for r in range(s))

    def extend_mask(off, s, cols):
        pos = off[:, None, None] + torch.arange(s, device="cuda")[None, :, None]
        return ((cols <= pos) & (cols > pos - w))[:, None]

    # B2 at the Mistral greedy prefill.
    b, s = MISTRAL_B, MISTRAL_PROMPT
    q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
    kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    i = torch.arange(s, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    b2 = measure(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=w),
                 lambda: flash_fwd.flash_attention_fwd_plain(q, k, v, causal=True, window=w),
                 lambda: f.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
                 4 * hq * d * visible_pairs([0] * b, s), 2 * (2 * q.numel() + 2 * k.numel()),
                 PEAK_BF16, f"B {b}, S {s}, window {w}, Hq {hq}, Hkv {hkv}; library_ms: SDPA with "
                 "the causal window as a boolean mask, GQA expanded", iters=10, plain_iters=3)
    rows = {"flash_fwd_window": {
        "name": "flash_fwd_window", "route": "cuda",
        "source": "flash_attention_cute_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:269", **b2}}
    del q, k, v, kr, vr, mask
    torch.cuda.empty_cache()

    # D1 and B7 at the Mistral greedy middle decode step (5136 keys, W 4096).
    b, cap, live = MISTRAL_B, MISTRAL_CAPACITY, MISTRAL_PROMPT + MISTRAL_NEW // 2
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    splits = dispatch.decode_num_splits(b, hkv, cap, d)
    q = randn(b, hq, 1, d)
    kc, vc = randn(b, hkv, cap, d), randn(b, hkv, cap, d)
    shape = f"B {b}, cache {cap}, lengths {live}, window {w}, splits {splits}"
    pos = torch.arange(cap, device="cuda")
    dmask = ((pos < live) & (pos >= live - w))[None, None, None, :]
    kcr, vcr = (x.repeat_interleave(rep, dim=1) for x in (kc, vc))
    rows["decode_partials"] = measure(
        lambda: flash_decode.decode_partials(q, kc, vc, lengths, d ** -0.5, splits, w),
        lambda: flash_decode.decode_partials_plain(q, kc, vc, lengths, d ** -0.5, splits, w),
        lambda: f.scaled_dot_product_attention(q, kcr, vcr, attn_mask=dmask),
        4 * b * hq * w * d, 2 * q.numel() + 2 * 2 * b * hkv * w * d + 4 * b,
        PEAK_BF16, shape, 50, 10)
    rows["decode_partials"].update(
        library_of=LIBRARY_OF_D1, with_combine_ms=cuda_time_ms(
            lambda: flash_decode.flash_attention_decode(q, kc, vc, lengths, window=w), 50))
    del kcr, vcr
    k8, v8 = (qz.quantize_kv(x, torch.int8) for x in (kc, vc))
    kd, vd = (qz.dequantize_kv(x, torch.bfloat16).repeat_interleave(rep, dim=1) for x in (k8, v8))
    rows["quant_decode"] = measure(
        lambda: qz.flash_attention_decode_quantized(q, k8, v8, lengths, window=w),
        lambda: qz.flash_attention_decode_quantized_plain(q, k8, v8, lengths, window=w),
        lambda: f.scaled_dot_product_attention(q, kd, vd, attn_mask=dmask),
        4 * b * hq * w * d, 2 * q.numel() + 2 * b * hkv * w * (d + 4) + 4 * b
        + 2 * q.numel(), PEAK_BF16, shape + ", int8; ms includes D2", 50, 10)
    del kc, vc, k8, v8, kd, vd

    # B4: a 256-token chunk at q_offset 4608 / 4864 (every query past W).
    offs, s, cap = [4608, 4864], 256, MISTRAL_CAPACITY
    q, k, v, off, kvl = chunked_inputs(torch, gen, torch.bfloat16, s, cap, offs, None, d)
    kr, vr = (x.nan_to_num().repeat_interleave(rep, dim=1) for x in (k, v))
    cols = torch.arange(cap, device="cuda")[None, None, :]
    rows["flash_chunked"] = measure(
        lambda: flash_chunked.flash_attention_chunked(q, k, v, off, kvl, window=w),
        lambda: flash_chunked.flash_attention_chunked_plain(q, k, v, off, kvl, window=w),
        lambda: f.scaled_dot_product_attention(q, kr, vr, attn_mask=extend_mask(off, s, cols)),
        4 * hq * d * visible_pairs(offs, s),
        2 * 2 * q.numel() + 2 * 2 * hkv * d * len(offs) * (w + s - 1) + 2 * 4 * len(offs),
        PEAK_BF16, f"B {len(offs)}, S {s}, capacity {cap}, q_offset {offs}, window {w}", 20, 3)
    del q, k, v, kr, vr

    # B5 / B8 at run M1's decode (4 slots, page_size 128), B6 / B9 at run
    # M2's extend (4 rows of 512, page_size 16).
    reqs = mistral_requests(32000)  # Mistral-7B's vocabulary
    lens_list = [len(p) + 24 for _, p, _ in reqs[:4]]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    b, ps, pps = 4, 128, 40
    kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=pps * ps, layers=1)
    kp, vp = kp[0], vp[0]
    q = randn(b, hq, 1, d)
    pos = torch.arange(pps * ps, device="cuda")[None, :]
    pmask = ((pos < lens[:, None]) & (pos >= lens[:, None] - w))[:, None, None, :]
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    tables = 4 * (b + sum(-(-min(n, w) // ps) + 1 for n in lens_list))
    shape = (f"B {b}, page_size {ps}, lengths {lens_list}, window {w}, splits "
             f"{dispatch.decode_num_splits(b, hkv, pps * ps, d)}")
    rows["paged_decode"] = measure(
        lambda: pa.paged_attention_decode(q, kp, vp, lens, table, window=w),
        lambda: pa.paged_attention_decode_plain(q, kp, vp, lens, table, window=w),
        lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=pmask),
        4 * b * hq * w * d, 2 * q.numel() + 2 * 2 * b * hkv * w * d + tables + 2 * q.numel(),
        PEAK_BF16, shape + "; ms includes D2", 50, 10)
    k8, v8, table8 = quant_pool(torch, qz, randn, gen, ps, b, torch.int8, capacity=pps * ps)
    kd, vd = (qz._gather_dequantized(x, table8).to(torch.bfloat16).repeat_interleave(rep, dim=1)
              for x in (k8, v8))
    rows["quant_paged_decode"] = measure(
        lambda: qz.paged_attention_decode_quantized(q, k8, v8, lens, table8, window=w),
        lambda: qz.paged_attention_decode_quantized_plain(q, k8, v8, lens, table8, window=w),
        lambda: f.scaled_dot_product_attention(q, kd, vd, attn_mask=pmask),
        4 * b * hq * w * d, 2 * q.numel() + 2 * b * hkv * w * (d + 4) + tables + 2 * q.numel(),
        PEAK_BF16, shape + ", int8; ms includes D2", 50, 10)
    del kp, vp, kc, vc, k8, v8, kd, vd

    b, ps, pps, s = 4, 16, 320, 512
    offs = [3584, 4096, 4096, 4608]
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl = off + s
    q = randn(b, s, hq, d).transpose(1, 2)
    cols = torch.arange(pps * ps, device="cuda")[None, None, :]
    emask = extend_mask(off, s, cols) & (cols < kvl[:, None, None])[:, None]
    ops_ = 4 * hq * d * visible_pairs(offs, s)
    live = sum(min(o + s, w + s - 1) for o in offs)  # keys some query of the chunk sees
    tables = 4 * (2 * b + sum(-(-min(o + s, w + s) // ps) + 1 for o in offs))
    shape = f"B {b}, S {s}, page_size {ps}, q_offset {offs}, window {w}"
    kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=pps * ps, layers=1)
    kp, vp = kp[0], vp[0]
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    rows["paged_extend"] = measure(
        lambda: pa.paged_attention_extend(q, kp, vp, off, kvl, table, window=w),
        lambda: pa.paged_attention_extend_plain(q, kp, vp, off, kvl, table, window=w),
        lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=emask),
        ops_, 2 * 2 * q.numel() + 2 * 2 * hkv * d * live + tables, PEAK_BF16, shape, 20, 3)
    del kp, vp, kc, vc
    k8, v8, table8 = quant_pool(torch, qz, randn, gen, ps, b, torch.float8_e4m3fn,
                                capacity=pps * ps)
    kd, vd = (qz._gather_dequantized(x, table8).to(torch.bfloat16).repeat_interleave(rep, dim=1)
              for x in (k8, v8))
    rows["quant_paged_extend"] = measure(
        lambda: qz.paged_attention_extend_quantized(q, k8, v8, off, kvl, table8, window=w),
        lambda: qz.paged_attention_extend_quantized_plain(q, k8, v8, off, kvl, table8, window=w),
        lambda: f.scaled_dot_product_attention(q, kd, vd, attn_mask=emask),
        ops_, 2 * 2 * q.numel() + 2 * hkv * live * (d + 4) + tables, PEAK_BF16,
        shape + ", e4m3", 20, 3)
    del k8, v8, kd, vd
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r.update(bound(r.pop("ops"), r.pop("bytes"), r.pop("peak")))
    return rows


def bound(ops, nbytes, peak) -> dict:
    """The least time the card could take: operations at `peak` or bytes at
    the memory rate, whichever is longer."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


L2_ROTATE = 100e6  # bytes of weight copies a timing cycles over: twice the H100's 50 MB L2


def qmm_rows(torch, cfg, gen):
    """Kernel rows of B10 (the unfused int8 tree) and B11 (the fused int4
    tree): every projection of the tree at its decode rows (T 4 = the
    greedy batch for int8, T 8 = a serving round for int4) and at T 2048 =
    4 x 512 (the greedy prefill), under "projections"; the row itself is the
    recorded shape (int8 gate_proj, N 14336; int4 fused gate_up_proj, N
    28672), with T 2048 under "prefill". Each timing cycles over copies of
    the weight totalling at least L2_ROTATE bytes, so that the weight comes
    from device memory as it does when a model streams its layers. Bytes:
    x, the logical weight (1 B or 0.5 B an element) and its scales, y, each
    once; operations 2 T K N at the bf16 tensor-core rate. `library_ms` is
    one bf16 `x @ w` over dequantized copies (the dequantization not
    timed)."""
    import dataclasses
    import itertools

    from flash_attention_cute_tpu_torch.ops import quantized_matmul as qmm
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    e, f = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_q_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    trees = (
        ("quantized_matmul", B, 149, "gate_proj / up_proj",
         {"q_proj / o_proj": (e, q), "k_proj / v_proj": (e, kv), "gate_proj / up_proj": (e, f),
          "down_proj": (f, e), "lm_head": (e, cfg.vocab_size)}),
        ("quantized_matmul_int4", 8, 360, "fused gate_up_proj",
         {"fused qkv_proj": (e, q + 2 * kv), "o_proj": (q, e), "fused gate_up_proj": (e, 2 * f),
          "down_proj": (f, e), "lm_head": (e, cfg.vocab_size)}),
    )

    def cycling(fn, items):
        it = itertools.cycle(items)
        return lambda: fn(next(it))

    def cycles(iters, copies):  # whole cycles over the copies, about `iters` calls
        return copies * max(1, round(iters / copies))

    rows = []
    for name, t_dec, line, recorded, shapes in trees:
        bits = QMM_KERNELS[name][0]
        projections, row = [], None
        for proj, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=gen, device="cuda").mul_(k ** -0.5)
            qw = (qmm.quantize_weight if bits == 8 else qmm.quantize_weight_int4)(w)
            del w
            w_bytes = k * n * bits // 8 + 4 * n * (1 if bits == 8 else k // qmm.GROUP4)
            copies = [qw] + [dataclasses.replace(qw, values=qw.values.clone(),
                                                 scales=qw.scales.clone())
                             for _ in range(-(-int(L2_ROTATE) // w_bytes) - 1)]
            dequant = qmm.dequantize_weight if bits == 8 else qmm.dequantize_weight4
            dense = [dequant(qw, torch.bfloat16)]
            dense += [dense[0].clone() for _ in range(-(-int(L2_ROTATE) // (2 * k * n)) - 1)]
            for t in (t_dec, B * PROMPT):
                x = torch.randn((t, k), generator=gen, device="cuda").to(torch.bfloat16)
                iters = 50 if t == t_dec else 10
                kernel = cycling(lambda w_: qmm.quantized_matmul(x, w_), copies)
                ops, nbytes = 2 * t * k * n, 2 * t * k + w_bytes + 2 * t * n
                entry = {
                    "projection": proj, "shape": f"T {t}, K {k}, N {n}",
                    "weight_copies": len(copies),
                    "ms": cuda_time_ms(kernel, cycles(iters, len(copies))),
                    "library_ms": cuda_time_ms(cycling(lambda d_: x @ d_, dense),
                                               cycles(iters, len(dense))),
                    **bound(ops, nbytes, PEAK_BF16),
                }
                projections.append(entry)
                if proj == recorded:
                    entry = dict(entry, call_ms=call_time_ms(kernel, cycles(iters, len(copies))),
                                 plain_ms=cuda_time_ms(
                                     lambda: qmm.quantized_matmul_plain(x, qw), 5))
                    if t == t_dec:
                        row = dict(entry, ops=ops, bytes=nbytes)
                    else:
                        row["prefill"] = entry
                del x
            del qw, copies, dense
            torch.cuda.empty_cache()
        rows.append({
            "name": name, "route": "cuda",
            "source": "flash_attention_cute_tpu_torch/csrc/quantized_matmul.cu",
            "replaces": f"flash_attention_cute_tpu/ops/quantized_matmul.py:{line}",
            **{key: row[key] for key in ("shape", "ms", "call_ms", "plain_ms", "library_ms",
                                         "ops", "bytes", "prefill")},
            "peak": PEAK_BF16, "projections": projections,
        })
    return rows


def tree_bytes(tree) -> int:
    """Bytes of a parameter dict: dense tensors and quantized leaves."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.nbytes  # a tensor, or a quantized leaf's values and scales


def profile_decode(torch, params, cfg, cache, tok, steps=4):
    """Device time per decode step and its top kernels, from torch.profiler
    (which slows the host side, so its wall time is reported apart)."""
    from torch.profiler import ProfilerActivity, profile
    from flash_attention_cute_tpu_torch.models.transformer import forward

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = forward(params, cfg, tok, cache=cache, mode="decode")
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Device-side events only: a CPU op also carries its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        return {"decode_profile": "not measured: the profiler recorded no device time"}
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=lambda e: -dev_us(e))[:12]
    return {
        "profiled_decode_steps": steps,
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "top_device_kernels_ms_per_step": [
            [e.key[:70], dev_us(e) / 1e3 / steps, e.count // steps] for e in top
        ],
    }


# Phase 3f: (name, batch, hq, hkv, sq, skv, d, causal, window, dtype) of the
# backward kernels B13a / B13b (and the lse of P / B2) against their plain
# versions; Llama-3-8B attention widths unless the name says otherwise.
BWD_CASES = (
    ("causal B2 S2048", 2, 32, 8, 2048, 2048, 128, True, None, "bfloat16"),
    ("non-causal S1024", 1, 32, 8, 1024, 1024, 128, False, None, "bfloat16"),
    ("window 100 S5120", 1, 32, 8, 5120, 5120, 128, True, 100, "bfloat16"),
    ("window 4096 S5120", 1, 32, 8, 5120, 5120, 128, True, 4096, "bfloat16"),
    ("Sq256 Skv1024", 1, 32, 8, 256, 1024, 128, True, None, "bfloat16"),
    ("Sq1024 Skv256 zero rows", 1, 32, 8, 1024, 256, 128, True, None, "bfloat16"),
    ("ragged S1000", 1, 32, 8, 1000, 1000, 128, True, None, "bfloat16"),
    ("D64 S1024", 2, 32, 8, 1024, 1024, 64, True, None, "bfloat16"),
    ("f16 S1024", 1, 32, 8, 1024, 1024, 128, True, None, "float16"),
    ("Qwen2-7B 28/4 S1024", 1, 28, 4, 1024, 1024, 128, True, None, "bfloat16"),
    ("short S130", 1, 32, 8, 130, 130, 128, True, None, "bfloat16"),
    ("Sq64 Skv1000", 1, 32, 8, 64, 1000, 128, True, None, "bfloat16"),
    ("Sq1000 Skv64 zero rows", 1, 32, 8, 1000, 64, 128, True, None, "bfloat16"),
    ("MQA group 32 S1024", 1, 32, 1, 1024, 1024, 128, True, None, "bfloat16"),
    # D 256 (B13a / B13b's own layout): Gemma-2-9B's 16 / 8 heads at its
    # prompt length, globally and under its window; Gemma-7B's MHA 16 / 16.
    ("Gemma2 D256 S4608", 1, 16, 8, 4608, 4608, 256, True, None, "bfloat16"),
    ("Gemma2 D256 window 4096 S4608", 1, 16, 8, 4608, 4608, 256, True, 4096, "bfloat16"),
    ("Gemma-7B MHA 16/16 D256 S2048", 1, 16, 16, 2048, 2048, 256, True, None, "bfloat16"),
    ("D256 ragged S1000", 1, 16, 8, 1000, 1000, 256, True, None, "bfloat16"),
    ("D256 Sq256 Skv1024", 1, 16, 8, 256, 1024, 256, True, None, "bfloat16"),
    ("D256 Sq1024 Skv256 zero rows", 1, 16, 8, 1024, 256, 256, True, None, "bfloat16"),
    ("D256 MQA group 32 S1024", 1, 32, 1, 1024, 1024, 256, True, None, "bfloat16"),
    ("D256 f16 S1024", 1, 16, 8, 1024, 1024, 256, True, None, "float16"),
    ("D256 split window 48 S300", 1, 4, 2, 300, 300, 256, True, 48, "bfloat16"),
)
LSE_TOL = 1e-3
GRAD_REL_TOL = 2e-2
SPLIT_REL_TOL = 2 ** -7  # B13a's split walk against one pass: fp32 sums grouped otherwise


def runtime_attributes(report: str, label: str) -> dict:
    """Registers, spill and shared bytes of one P / B2, B6, B9 or B13a /
    B13b instantiation as the runtime reports them (`kernel_report()` of
    ops/flash_fwd.py, ops/paged_attention.py and ops/flash_bwd.py,
    `extend_kernel_report()` of ops/quantized.py)."""
    line = next(x for x in report.splitlines() if x.startswith(label + ":"))
    regs, spill, shared = (int(n) for n in re.findall(r"(\d+) (?:registers|bytes)", line))
    return {"instantiation": label, "registers_at_launch": regs, "spill_bytes": spill,
            "shared_bytes": shared}


def rel_err(a, b) -> float:
    """max |a - b| over max |b|: gradients grow with the sequence."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


def phase_training_kernels(torch, ops, errs, rel_errs):
    """The lse of P / B2 and the backward kernels B13a (dK, dV) and B13b (dQ)
    against their plain versions, fed one and the same o, dO and lse (the
    kernel forward's), on the model's transposed q / k / v views and a
    non-contiguous dO; then autograd through `ops.autodiff.flash_attention`
    against autograd through the fp32 reference.

    Tolerances: the lse (log2 units) within LSE_TOL of the plain fp32 lse on
    finite entries, the same +inf pattern (both sum the same fp32
    probabilities in another order). Gradients within GRAD_REL_TOL of the
    plain fp32 gradient, as max |diff| / max |plain|: they grow with S, and
    the kernels round P and dS to bf16 / f16 before their products (one step
    is 2^-8 relative), as the forward rounds P before PV. Where `dkv_splits`
    splits B13a's walk, its dK / dV are held to one pass over the walk
    (`launch(..., splits=1)`) within SPLIT_REL_TOL: the same fp32 sums,
    grouped otherwise, each rounded once. Errors at D 256 also go to the
    "<kernel> d256" entries of `errs` / `rel_errs`."""
    flash_fwd, flash_bwd, autodiff = ops["flash_fwd"], ops["flash_bwd"], ops["autodiff"]
    gen = torch.Generator(device="cuda").manual_seed(7070)
    for name, b, hq, hkv, sq, skv, d, causal, window, dt in BWD_CASES:
        dtype = getattr(torch, dt)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = randn(b, sq, hq, d).transpose(1, 2)
        k, v = (randn(b, skv, hkv, d).transpose(1, 2) for _ in "kv")
        do = randn(b, sq, hq, d).transpose(1, 2)
        o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                               return_lse=True)
        _, ref = flash_fwd.flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                                     return_lse=True)
        check(torch.equal(torch.isinf(lse), torch.isinf(ref)), f"{name}: lse +inf pattern")
        fin = torch.isfinite(ref)
        e_lse = (lse[fin] - ref[fin]).abs().max().item()
        fwd_name = "flash_fwd_window" if window and window < skv else "flash_fwd"
        errs[f"{fwd_name} lse"] = max(errs.get(f"{fwd_name} lse", 0.0), e_lse)
        check(e_lse <= LSE_TOL, f"{name}: lse within {LSE_TOL}")
        if sq > skv and causal:
            check(bool(torch.isinf(lse[:, :, : sq - skv]).all()), f"{name}: dead rows' lse +inf")
        del ref
        before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
        got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        torch.cuda.synchronize()
        check((flash_bwd.DKV.launches - before[0], flash_bwd.DQ.launches - before[1]) == (1, 1),
              f"{name}: one launch each of B13a and B13b")
        again = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        check(all(torch.equal(a, b2) for a, b2 in zip(got, again)),
              f"{name}: a second call gives bit-identical dq / dk / dv")
        del again
        want = flash_bwd.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do, lse,
                                                   causal=causal, window=window)
        rel = [rel_err(a, w) for a, w in zip(got, want)]
        for kname, idx in (("flash_bwd_dq", (0,)), ("flash_bwd_dkv", (1, 2))):
            for key in (kname, f"{kname} d256") if d == 256 else (kname,):
                errs[key] = max([errs.get(key, 0.0)] + [max_err(got[i], want[i]) for i in idx])
                rel_errs[key] = max([rel_errs.get(key, 0.0)] + [rel[i] for i in idx])
        del want
        splits = flash_bwd.dkv_splits(b, hkv, hq // hkv, sq, skv, d)
        split_note = ""
        if splits > 1:  # the split walk against one pass over it
            one = (torch.empty_like(got[1]), torch.empty_like(got[2]))
            delta = (do.float() * o.float()).sum(-1)
            flash_bwd.launch(flash_bwd.DKV, q, k, v, do, lse, delta, *one, d ** -0.5, causal,
                             window or 0, splits=1)
            e_split = max(rel_err(got[1], one[0]), rel_err(got[2], one[1]))
            split_note = f" (against one pass: {e_split:.2e})"
            check(e_split <= SPLIT_REL_TOL,
                  f"{name}: B13a in {splits} parts within {SPLIT_REL_TOL} of one pass")
            del one, delta
        print(f"  B13 {name} (Hq {hq} Hkv {hkv} D {d} {dt}, window {window}): lse max|diff| "
              f"{e_lse:.2e}; dq / dk / dv max|diff| / max|plain| "
              + " / ".join(f"{r:.2e}" for r in rel)
              + f"; B13a splits {splits}{split_note}; repeated bit for bit")
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: gradients finite")
        check(max(rel) <= GRAD_REL_TOL, f"{name}: gradients within {GRAD_REL_TOL} (relative)")
        if sq > skv and causal:
            check(bool((got[0][:, :, : sq - skv] == 0).all()), f"{name}: dq rows with no key 0")
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()

    # autograd through the op against autograd through the fp32 reference.
    q = torch.randn((2, 32, 2048, 128), generator=gen, device="cuda").bfloat16().requires_grad_()
    k, v = (torch.randn((2, 8, 2048, 128), generator=gen, device="cuda").bfloat16()
            .requires_grad_() for _ in "kv")
    do = torch.randn((2, 32, 2048, 128), generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(autodiff.flash_attention(q, k, v, causal=True), (q, k, v), do)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_fwd.flash_attention_fwd_plain(*leaves, causal=True),
                               leaves, do.float())
    rel = [rel_err(a, w) for a, w in zip(got, want)]
    print("  autograd through ops.autodiff.flash_attention vs the fp32 reference (B 2, S 2048, "
          "causal): dq / dk / dv max|diff| / max|ref| " + " / ".join(f"{r:.2e}" for r in rel))
    check(max(rel) <= GRAD_REL_TOL, f"autograd grads within {GRAD_REL_TOL} (relative)")
    del q, k, v, do, got, want, leaves
    torch.cuda.empty_cache()


def varlen_batch(rng_seed=0, count=32):
    """The packed batch of phases 3g / 4i: `count` sequences of numpy-seeded
    lengths in [100, 2048], one of them a single token, the total not a
    multiple of 64; kv lengths 0-512 longer for the cross case."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    lens = rng.integers(100, 2049, count)
    lens[5] = 1
    if lens.sum() % 64 == 0:
        lens[-1] -= 1
    extra = rng.integers(0, 513, count)
    return [int(x) for x in lens], [int(x + e) for x, e in zip(lens, extra)]


def varlen_inputs(torch, gen, lens_q, lens_kv, hq=32, hkv=8, d=128):
    def randn(*shape):  # at the port's row pitch
        return pitched(torch, torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))

    def cu(lens):
        return torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)

    return (randn(sum(lens_q), hq, d), randn(sum(lens_kv), hkv, d), randn(sum(lens_kv), hkv, d),
            cu(lens_q), cu(lens_kv))


def varlen_plain(torch, flash_varlen, q, k, v, cu_q, cu_kv, **kw):
    """B12's plain version behind the cu_seqlens front end, on q's fp32
    image: each sequence's dense attention in fp32, run per segment."""
    seg_q, pos_q = flash_varlen._seg_metadata(cu_q, q.shape[0])
    seg_kv, pos_kv = flash_varlen._seg_metadata(cu_kv, k.shape[0])
    bounds = pos_q + (cu_kv.diff() - cu_q.diff())[seg_q.long()]
    return flash_varlen.flash_attention_packed_plain(
        q.float().transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), seg_q, seg_kv,
        bounds, pos_kv, **kw).transpose(0, 1)


def phase_varlen_kernels(torch, flash_varlen, errs):
    """B12 against its plain version (each sequence's dense attention in
    fp32 on q's fp32 image, run per segment: never a [T, T] matrix) over 32
    packed sequences of 100-2048 tokens at Llama-3-8B widths: self-attention
    causal and full, kv 0-512 tokens longer than q per sequence (bottom-right
    causality, rows of a sequence longer than its keys exact zeros), a
    causal window of 256; then at Gemma-2-9B widths (16 / 8 heads, D 256)
    with the soft caps 50 and 1.0, causal and with kv longer and its window
    of 4096. Every call repeated bit for bit. Tolerance BF16_TOL (a bf16
    result of fp32 arithmetic on bf16 inputs). Errors at D 256 also go to
    the "flash_varlen gemma2" entry of `errs`."""
    gen = torch.Generator(device="cuda").manual_seed(7171)
    lens_q, lens_kv = varlen_batch()
    print(f"  packed batch: {len(lens_q)} sequences, {sum(lens_q)} tokens (lengths "
          f"{min(lens_q)}-{max(lens_q)}; kv {sum(lens_kv)} tokens in the cross case)")
    for name, kv_lens, causal, window, (hq, hkv, d), cap in (
            ("causal", None, True, None, (32, 8, 128), None),
            ("full", None, False, None, (32, 8, 128), None),
            ("cross kv +0-512", lens_kv, True, None, (32, 8, 128), None),
            ("window 256", None, True, 256, (32, 8, 128), None),
            ("Gemma widths D 256 cap 50, causal", None, True, None, (16, 8, 256), 50.0),
            ("Gemma widths D 256 cap 1.0, cross kv +0-512, window 4096", lens_kv, True, 4096,
             (16, 8, 256), 1.0)):
        q, k, v, cu_q, cu_kv = varlen_inputs(torch, gen, lens_q, kv_lens or lens_q, hq, hkv, d)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        before = flash_varlen.VARLEN.launches
        out = flash_varlen.flash_attention_varlen(q, k, v, cu_q, cu_kv, **kw)
        again = flash_varlen.flash_attention_varlen(q, k, v, cu_q, cu_kv, **kw)
        torch.cuda.synchronize()
        check(flash_varlen.VARLEN.launches == before + 2, f"B12 {name}: one launch a call")
        ref = varlen_plain(torch, flash_varlen, q, k, v, cu_q, cu_kv, **kw)
        e = max_err(out, ref)
        for key in ("flash_varlen", "flash_varlen gemma2") if d == 256 else ("flash_varlen",):
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"  B12 {name}: max|diff| {e:.3e}")
        check(bool(torch.isfinite(out).all()), f"B12 {name}: finite")
        check(e <= BF16_TOL, f"B12 {name} within {BF16_TOL}")
        check(torch.equal(out, again), f"B12 {name} repeats bit for bit")
        if kv_lens is None and causal and cap is None:
            one = sum(lens_q[:5])  # the 1-token sequence sees itself: its V row
            check(max_err(out[one], v[one].repeat_interleave(hq // hkv, dim=0)) == 0.0,
                  "B12: a 1-token sequence returns its own V row")
        del q, k, v, out, again, ref
        torch.cuda.empty_cache()


TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 2, 2048, 3, 3e-4
TRAIN_GRAD_TOL = 0.05


def next_token_loss(torch, params, cfg, ids, plain=False):
    """The loss of tests/test_autodiff.py: mean next-token NLL in fp32."""
    from flash_attention_cute_tpu_torch.models.transformer import forward

    logits, _ = forward(params, cfg, ids, plain_attention=plain)
    return torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())


def phase_training(torch, cfg, kernels, path_counts, batch=TRAIN_B, seq=TRAIN_S,
                   path="training", seed=3):
    """Three AdamW steps of a model at full width, depth cut (printed), on
    one batch of numpy-seeded ids; every parameter trained. Launches per
    step: P on each layer whose window cannot bind, B2 on the others
    (`prefill_counts`), B13a and B13b on every layer, counted under `path`."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from flash_attention_cute_tpu_torch.models.transformer import init_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    top = [n for n in params if n != "layers"]  # embed, final_ln and lm_head unless tied
    names = top + list(params["layers"])
    leaves = [params[n] for n in top] + list(params["layers"].values())
    for w in leaves:
        w.requires_grad_()
    ids = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    torch.cuda.synchronize()
    print(f"  tree drawn in {time.perf_counter() - t0:.1f} s ({tree_bytes(params) / 1e9:.2f} GB)")

    # First-step gradients on the plain route (fp32 attention scores).
    next_token_loss(torch, params, cfg, ids, plain=True).backward()
    plain_grads = [w.grad for w in leaves]
    for w in leaves:
        w.grad = None
    torch.cuda.empty_cache()

    opt = torch.optim.AdamW(leaves, lr=TRAIN_LR)
    for k in kernels.values():
        k.launches = 0
    losses, step_s, grad_rel = [], [], {}
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = next_token_loss(torch, params, cfg, ids)
        loss.backward()
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
        if step == 0:  # not timed: the first step's gradients vs the plain route's
            for n, w, g in zip(names, leaves, plain_grads):
                check(bool(torch.isfinite(w.grad).all()), f"training: {n} gradient finite")
                grad_rel[n] = ((w.grad.float() - g.float()).norm() / g.float().norm()).item()
            del plain_grads
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(t_bwd + time.perf_counter() - t0)
        losses.append(loss.item())
    counts = {name: k.launches for name, k in kernels.items()}
    path_counts[path] = counts
    n = cfg.num_layers * TRAIN_STEPS
    print(f"  losses {[round(x, 4) for x in losses]} (lr {TRAIN_LR}); step s "
          f"{[round(x, 3) for x in step_s]}; launches { {k: c for k, c in counts.items() if c} }")
    print("  first-step gradients, kernel route vs plain route, |diff| / |plain| per leaf: "
          + ", ".join(f"{k} {v:.2e}" for k, v in grad_rel.items()))
    fwd = {k: c * TRAIN_STEPS for k, c in prefill_counts(cfg, seq).items() if c}
    check_counts(counts, {**fwd, "flash_bwd_dkv": n, "flash_bwd_dq": n}, path)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training loss falls from step 1 to step {TRAIN_STEPS}: {losses}")
    check(max(grad_rel.values()) <= TRAIN_GRAD_TOL,
          f"first-step gradients within {TRAIN_GRAD_TOL} of the plain route's (relative norm)")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # The profiler's split of one more step (not counted: a fourth step).
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.zero_grad(set_to_none=True)
        next_token_loss(torch, params, cfg, ids).backward()
        opt.step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernels only: a user annotation's range (the optimizer step's) would
    # count its kernels twice.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    fwd_part = "P / B2 (forward with lse)" if "flash_fwd_window" in fwd else "P (forward with lse)"
    split = {"B13a dK/dV": 0.0, "B13b dQ": 0.0, fwd_part: 0.0, "cuBLAS products": 0.0,
             "other": 0.0}
    other = []
    for e in events:
        key = e.key
        part = ("B13a dK/dV" if "flash_bwd_dkv" in key else "B13b dQ" if "flash_bwd_dq" in key
                else fwd_part if "flash_fwd_kernel" in key
                else "cuBLAS products" if any(s in key.lower() for s in (
                    "nvjet", "gemm", "cutlass", "xmma", "cublas")) else "other")
        split[part] += dev_us(e) / 1e3
        if part == "other":
            other.append([key[:70], dev_us(e) / 1e3, e.count])
    top_other = sorted(other, key=lambda x: -x[1])[:6]
    print("  profiled step, device ms: " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" (total {sum(split.values()):.2f}); largest other: {top_other}"
          if events else "  profiler recorded no device time")
    mean_s = sum(step_s[1:]) / len(step_s[1:])
    out = {
        "layers": cfg.num_layers, "batch": batch, "seq": seq, "lr": TRAIN_LR,
        "losses": losses, "step_s": step_s, "step_ms_steady": 1e3 * mean_s,
        "tokens_per_s_steady": batch * seq / mean_s,
        "first_step_grad_rel_norm_err_max": max(grad_rel.values()),
        "first_step_grad_rel_norm_err": grad_rel, "peak_memory_gb": peak,
        "profiled_step_device_ms": split if events else "not measured",
        "profiled_step_largest_other_ms": top_other,
    }
    print(f"  step ms (steps 2-{TRAIN_STEPS}) {out['step_ms_steady']:.1f}, tokens/s "
          f"{out['tokens_per_s_steady']:.0f}, peak {peak:.2f} GB")
    del params, leaves, opt, loss
    torch.cuda.empty_cache()
    return out


# Phase 4l: Gemma-2-9B's widths with the attention cap off, trained over
# Gemma's prompt length (past its window of 4096).
GEMMA2_TRAIN_LAYERS, GEMMA2_TRAIN_B, GEMMA2_TRAIN_S = 8, 1, 4608
GEMMA2_TRAIN_PATH = "training Gemma 2"
CARD_GB, CARD_USE = 80, 0.9  # H100 memory, and the share a reckoning may fill


def gemma2_training_config(layers=0):
    """(config, why): Gemma-2-9B with `logit_softcap=None`, its depth cut to
    GEMMA2_TRAIN_LAYERS, or to 6 where the reckoning of the plain route's
    first step does not fit CARD_USE of the card, or to `layers` (the
    smoke's --layers) if fewer. The reckoning: weights, gradients and two
    AdamW states in bf16 (8 bytes a parameter); the plain route's saved fp32
    scores (the softmax output and the masked probabilities, 8 B Hq S^2
    bytes a layer); about five fp32 [B, S, vocab] tensors of the logits,
    their final cap and the loss."""
    import dataclasses
    from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_9b_config

    full = dataclasses.replace(gemma2_9b_config(), logit_softcap=None)
    e, f, d = full.hidden_size, full.intermediate_size, full.head_dim
    per_layer = e * d * (2 * full.num_q_heads + 2 * full.num_kv_heads) + 3 * e * f + 4 * e

    def reckon(n):
        states = 8 * (n * per_layer + full.vocab_size * e + e) / 1e9
        scores = 8 * GEMMA2_TRAIN_B * full.num_q_heads * GEMMA2_TRAIN_S ** 2 * n / 1e9
        logits = 20 * GEMMA2_TRAIN_B * GEMMA2_TRAIN_S * full.vocab_size / 1e9
        return states, scores, logits

    n = GEMMA2_TRAIN_LAYERS if sum(reckon(GEMMA2_TRAIN_LAYERS)) <= CARD_USE * CARD_GB else 6
    states, scores, logits = reckon(n)
    why = (f"AdamW over {full.num_layers} bf16 layers needs {reckon(full.num_layers)[0]:.1f} GB "
           f"for weights, gradients and two states alone; at {n} layers those take "
           f"{states:.1f} GB, the plain route's saved fp32 scores {scores:.1f} GB and the "
           f"logits and loss about {logits:.1f} GB: {states + scores + logits:.1f} of {CARD_GB} GB")
    if layers and layers < n:
        n, why = layers, f"--layers {layers}"
    return dataclasses.replace(full, num_layers=n), why


def phase_varlen_path(torch, kernels, path_counts):
    """The cu_seqlens entry point as a caller runs it: the 32-sequence
    packed batch of phase 3g, causal, once (B12 1 launch)."""
    from flash_attention_cute_tpu_torch import flash_attention_varlen

    lens_q, _ = varlen_batch()
    q, k, v, cu, _ = varlen_inputs(torch, torch.Generator(device="cuda").manual_seed(7272),
                                   lens_q, lens_q)
    out, wall, counts = counted_run(torch, kernels,
                                    lambda: flash_attention_varlen(q, k, v, cu, causal=True))
    path_counts["varlen"] = counts
    check_counts(counts, {"flash_varlen": 1}, "varlen")
    check(tuple(out.shape) == tuple(q.shape) and bool(torch.isfinite(out).all()),
          "varlen output finite, [T, Hq, D]")
    print(f"  flash_attention_varlen over {len(lens_q)} sequences ({q.shape[0]} tokens): "
          f"{wall * 1e3:.2f} ms (host clock), launches { {k: c for k, c in counts.items() if c} }")


def training_rows(torch, ops, gen, path_counts):
    """Kernel rows of B13a and B13b at the training step's attention (B 2,
    S 2048, causal, Llama-3-8B widths) and of B12 at the 32-sequence packed
    batch. Bounds: B13a 8 D and B13b 6 D operations per visible (row, key)
    pair and q head, B12 4 D, at the bf16 tensor-core rate, or their bytes
    (inputs once, outputs once), whichever is longer. `plain_ms` of B13a and
    B13b is the whole plain backward (it computes dq, dk and dv at once),
    their `library_ms` the backward of SDPA (is_causal, enable_gqa) timed as
    forward + backward minus forward, also for all three gradients. B12's
    `library_ms` is SDPA (is_causal, enable_gqa) over the batch padded to
    [32, 32, 2048, 128]: it computes the padding too."""
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    flash_fwd, flash_varlen = ops["flash_fwd"], ops["flash_varlen"]
    f = torch.nn.functional
    b, hq, hkv, s, d = TRAIN_B, 32, 8, TRAIN_S, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = []
    for name, entry in bwd_timings(torch, ops, randn, b, hq, hkv, s, d).items():
        library = entry.pop("library")
        rows.append({
            "name": name, "route": "cuda", "source": "flash_attention_cute_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "flash_attention_cute_tpu/ops/flash_bwd.py:"
                        + ("84" if name == "flash_bwd_dkv" else "173"),
            "shape": f"B {b}, S {s}, causal, Hq {hq}, Hkv {hkv}, D {d}; plain_ms: the whole plain "
                     f"backward; library_ms: {library}, all three gradients", **entry})
    # The lse's cost: P at the training shape, B2 at its row's (Mistral-7B
    # greedy prefill, W 4096).
    lse_cost = {}
    q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
    for name, bb, ss, w in (("flash_fwd", b, s, None),
                            ("flash_fwd_window", MISTRAL_B, MISTRAL_PROMPT, WINDOW)):
        if ss != s:
            q, k, v = randn(bb, hq, ss, d), randn(bb, hkv, ss, d), randn(bb, hkv, ss, d)
        lse_cost[name] = {
            "shape": f"B {bb}, S {ss}, causal, window {w}",
            "ms_without_lse": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(
                q, k, v, causal=True, window=w), 10),
            "ms_with_lse": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(
                q, k, v, causal=True, window=w, return_lse=True), 10)}
        if w is None:  # the training step's forward: its launches, bound and SDPA's forward
            pairs = bb * hq * ss * (ss + 1) // 2
            lse_cost[name].update(
                launches_with_lse=path_counts["training"]["flash_fwd"],
                plain_ms=cuda_time_ms(lambda: flash_fwd.flash_attention_fwd_plain(
                    q, k, v, causal=True, return_lse=True), 3),
                library_ms=cuda_time_ms(lambda: f.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 10),
                library="SDPA forward (is_causal, enable_gqa)",
                **bound(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()) + 4 * bb * hq * ss,
                        PEAK_BF16))
    del q, k, v
    torch.cuda.empty_cache()

    rows.append({"name": "flash_varlen", "route": "cuda",
                 "source": "flash_attention_cute_tpu_torch/csrc/flash_varlen.cu",
                 "replaces": "flash_attention_cute_tpu/ops/flash_varlen.py:48",
                 **varlen_row(torch, flash_varlen, gen, hq, hkv, d)})
    return rows, lse_cost


def varlen_row(torch, flash_varlen, gen, hq, hkv, d):
    """B12 at the 32-sequence packed batch (`varlen_batch`), causal, at
    (Hq, Hkv, D): ms, call_ms, plain_ms, library_ms (SDPA, is_causal and
    enable_gqa, over the batch padded to [32, Hq, 2048, D]: it computes the
    padding too), the bound at D (4 D operations per visible pair and q head
    at the bf16 rate, or the bytes of q, k, v, the output and the metadata
    once, whichever is longer) and the shape."""
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    lens, _ = varlen_batch()
    q, k, v, cu, _ = varlen_inputs(torch, gen, lens, lens, hq, hkv, d)
    seg, pos = flash_varlen._seg_metadata(cu, q.shape[0])
    qp, kp, vp = (torch.zeros((len(lens), h, max(lens), d), dtype=torch.bfloat16, device="cuda")
                  for h in (hq, hkv, hkv))
    for i, n in enumerate(lens):
        a = int(cu[i])
        for dst, src in ((qp, q), (kp, k), (vp, v)):
            dst[i, :, :n] = src[a:a + n].transpose(0, 1)
    pairs = sum(n * (n + 1) // 2 for n in lens)

    def run():
        return flash_varlen.flash_attention_varlen(q, k, v, cu, causal=True)

    row = {
        "shape": f"{len(lens)} sequences of {min(lens)}-{max(lens)} tokens ({q.shape[0]} packed), "
                 f"causal, Hq {hq}, Hkv {hkv}, D {d}; library_ms: SDPA (is_causal, enable_gqa) over "
                 f"the batch padded to [{len(lens)}, {hq}, {max(lens)}, {d}], padding computed too",
        "ms": cuda_time_ms(run, 10), "call_ms": call_time_ms(run, 10),
        "plain_ms": cuda_time_ms(lambda: flash_varlen.flash_attention_packed_plain(
            q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), seg, seg, pos, pos,
            causal=True), 2),
        "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(
            qp, kp, vp, is_causal=True, enable_gqa=True), 10),
        **bound(4 * d * hq * pairs, 2 * (2 * q.numel() + 2 * k.numel()) + 4 * 4 * q.shape[0],
                PEAK_BF16)}
    del q, k, v, qp, kp, vp
    torch.cuda.empty_cache()
    return row


def bwd_timings(torch, ops, randn, b, hq, hkv, s, d):
    """B13a and B13b, each launched alone over the kernel forward's o and
    lse at (B, Hq, Hkv, S, D), causal: {name: ms, call_ms, plain_ms (the
    whole plain backward: it computes dq, dk and dv at once), library_ms
    (SDPA's backward, is_causal and enable_gqa, timed as forward + backward
    minus forward, all three gradients; None where SDPA raises), "library"
    (what library_ms is, or why it is null) and the bound (B13a 8 D and
    B13b 6 D operations per visible pair and q head at the bf16 peak, or
    the bytes of the inputs and outputs once, whichever is longer)}."""
    from flash_attention_cute_tpu_torch.ops import _build
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    flash_fwd, flash_bwd = ops["flash_fwd"], ops["flash_bwd"]
    f = torch.nn.functional
    q, do = randn(b, hq, s, d), randn(b, hq, s, d)
    k, v = randn(b, hkv, s, d), randn(b, hkv, s, d)
    o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = (_build.empty_rows(x.shape, x.dtype, x.device) for x in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * 2 * lse.numel()  # q, dO, k, v; lse, delta
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return f.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    try:
        lib_ms = (cuda_time_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do), 10)
                  - cuda_time_ms(sdpa, 10))
        library = "SDPA backward (is_causal, enable_gqa), fwd + bwd - fwd"
    except RuntimeError as err:  # no SDPA backend of the card takes the shape
        lib_ms, library = None, f"null: SDPA's backward raised ({str(err)[:160]})"
    plain_ms = cuda_time_ms(lambda: flash_bwd.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                                        causal=True), 3)
    out = {}
    for name, kernel, outs, ops_per_pair, out_bytes in (
            ("flash_bwd_dkv", flash_bwd.DKV, (dk, dv), 8, 2 * 2 * k.numel()),
            ("flash_bwd_dq", flash_bwd.DQ, (dq, None), 6, 2 * q.numel())):
        def fn(kernel=kernel, outs=outs):
            flash_bwd.launch(kernel, q, k, v, do, lse, delta, *outs, d ** -0.5, True, 0)
        out[name] = {"ms": cuda_time_ms(fn, 10), "call_ms": call_time_ms(fn, 10),
                     "plain_ms": plain_ms, "library_ms": lib_ms, "library": library,
                     **bound(ops_per_pair * d * pairs, io + out_bytes, PEAK_BF16)}
    del q, k, v, do, o, lse, delta, dq, dk, dv, qs, ks, vs
    torch.cuda.empty_cache()
    return out


def gemma2_training_rows(torch, ops, gen):
    """The "gemma2" entries of the B13a / B13b rows (`bwd_timings`) at phase
    4l's global layer: B 1, S 4608, 16 / 8 heads, D 256, causal."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = bwd_timings(torch, ops, randn, GEMMA2_TRAIN_B, 16, 8, GEMMA2_TRAIN_S, 256)
    for entry in out.values():
        library = entry.pop("library")
        entry["shape"] = (f"B {GEMMA2_TRAIN_B}, S {GEMMA2_TRAIN_S}, causal, Hq 16, Hkv 8, D 256 "
                          f"(phase 4l's global layer); plain_ms: the whole plain backward; "
                          f"library_ms: {library} at D 256")
    print(f"  gemma2 entries of B13a / B13b: {library} at D 256")
    return out


# Phases 3h / 4j / 5d: Gemma-2-9B (head dim 256, a window of 4096 on the
# even layers, soft caps 50 on the scores and 30 on the final logits).
GEMMA2_B, GEMMA2_PROMPT, GEMMA2_NEW = 2, 4608, 32
GEMMA2_CAPACITY = GEMMA2_PROMPT + GEMMA2_NEW
GEMMA2_CAPS = (50.0, 1.0)  # the model's, and one that binds on every score
GEMMA2_KEEP = 64  # teacher forcing compares every 64th prefill position and the last


def phase_gemma2_kernels(torch, ops, errs):
    """D1 + D2 and B7 + D2 over CONTIG_DECODE_CASES["gemma2"]; P / B2, D1 +
    D2, B5, B6, B9 and the paged append at Gemma-2-9B
    attention widths (Hq 16, Hkv 8, D 256, scale 256 ** -0.5) with the soft
    caps 50 and 1.0, and P, D1, B5, B6, B9 with the caps at Llama widths (32
    / 8, D 128), against their fp32 plain versions (run on q's fp32 image);
    caches and pools NaN past every length (B9: its scales and e4m3
    values), pools behind permuted tables. Errors at D 256 also go to the
    "<kernel> gemma2" entries of `errs`."""
    from flash_attention_cute_tpu_torch.runtime import paged_cache

    flash_fwd, flash_decode, pa = ops["flash_fwd"], ops["flash_decode"], ops["paged_attention"]
    qz = ops["quantized"]
    gen = torch.Generator(device="cuda").manual_seed(8080)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def record(name, d, e):
        for key in (name, f"{name} gemma2") if d == 256 else (name,):
            errs[key] = max(errs.get(key, 0.0), e)

    def held(name, what, d, out, ref, tol=BF16_TOL):
        """`out` within tol of `ref`; its error recorded under `name` (None:
        checked only, as for D1 + D2 against the fp32 plain route)."""
        e = max_err(out, ref)
        if name:
            record(name, d, e)
        print(f"  {what}: max|diff| {e:.3e}")
        check(bool(torch.isfinite(out).all()), f"{what}: finite")
        check(e <= tol, f"{what} within {tol}")

    held_contiguous_decodes(torch, flash_decode, qz, errs, gen, CONTIG_DECODE_CASES["gemma2"])
    for cap in GEMMA2_CAPS:
        for name, b, sq, skv, w, dt, (hq, hkv, d) in (
                ("causal B2 S4608", 2, 4608, 4608, None, torch.bfloat16, (16, 8, 256)),
                ("window 4096 B2 S4608", 2, 4608, 4608, WINDOW, torch.bfloat16, (16, 8, 256)),
                ("Sq256 Skv1024", 1, 256, 1024, None, torch.bfloat16, (16, 8, 256)),
                ("ragged S1000 f16", 1, 1000, 1000, None, torch.float16, (16, 8, 256)),
                ("Sq1000 Skv64 zero rows", 1, 1000, 64, None, torch.bfloat16, (16, 8, 256)),
                ("MQA group 16 S1000", 1, 1000, 1000, None, torch.bfloat16, (16, 1, 256)),
                ("causal B2 S1024 (Llama widths)", 2, 1024, 1024, None, torch.bfloat16,
                 (32, 8, 128))):
            q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
                randn(b, hkv, skv, d, dtype=dt)
            held_prefill(torch, flash_fwd, errs, f"{'B2' if w else 'P'} D {d} cap {cap:g} {name}",
                         q, k, v, True, w, cap, tag="gemma2" if d == 256 else None)
            del q, k, v
        torch.cuda.empty_cache()

        for hq, hkv, d, cap_len, lens_list in ((16, 8, 256, GEMMA2_CAPACITY, [4640, 4600, 2000, 0]),
                                               (32, 8, 128, 576, [576, 513, 37, 0])):
            kc, vc = randn(4, hkv, cap_len, d), randn(4, hkv, cap_len, d)
            for i, n in enumerate(lens_list):  # uninitialised cache tail
                kc[i, :, n:] = float("nan")
                vc[i, :, n:] = float("nan")
            q = randn(4, hq, 1, d)
            lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
            for w in ((None, WINDOW) if d == 256 else (None,)):
                splits = 5
                acc, m, l = flash_decode.decode_partials(q, kc, vc, lengths, d ** -0.5, splits,
                                                         w, cap)
                ref = flash_decode.decode_partials_plain(q, kc, vc, lengths, d ** -0.5, splits,
                                                         w, cap)
                e1 = max(max_err(x, y) for x, y in zip((acc, m, l), ref))
                record("decode_partials", d, e1)
                check(e1 <= 1e-2, f"D1 D {d} cap {cap:g} window {w} partials within 1e-2")
                o = flash_decode.decode_combine(acc, m, l, torch.bfloat16)
                held("decode_combine", f"D2 D {d} cap {cap:g} window {w} (D1 partials "
                     f"{e1:.3e})", d, o, flash_decode.decode_combine_plain(acc, m, l,
                                                                            torch.bfloat16))
                out = flash_decode.flash_attention_decode(q, kc, vc, kv_length=lengths, window=w,
                                                          logit_softcap=cap)
                ref = flash_decode.flash_attention_decode_plain(q.float(), kc, vc,
                                                                kv_length=lengths, window=w,
                                                                logit_softcap=cap)
                held(None, f"D1 + D2 D {d} cap {cap:g} window {w}, lengths "
                     f"{lens_list}", d, out, ref)
                check(bool((out[3] == 0).all()), "decode row of length 0 is 0")
            del kc, vc

        for ps in (16, 128):
            # B5 / B8 at Gemma's widths, at Llama's, and at Llama's q heads
            # over one kv head (a group of 32: two m-tiles a block).
            for hq, hkv, d in ((16, 8, 256), (32, 8, 128), (32, 1, 128)):
                kp, vp, table = paged_pool(torch, randn, gen, ps, rows=8, capacity=4096,
                                           layers=1, d=d, hkv=hkv)
                full = table.shape[1] * ps
                lens = torch.tensor([0, 1, ps - 1, ps + 1, full, 4000, 777, 33],
                                    dtype=torch.int32, device="cuda")
                poison_past(torch, kp, table, lens)
                poison_past(torch, vp, table, lens)
                q = randn(8, hq, 1, d)
                # B8 over the same rows: int8 pages of 16, e4m3 pages of 128.
                dname = "int8" if ps == 16 else "float8_e4m3fn"
                kq, vq, tq = quant_pool(torch, qz, randn, gen, ps, 8, getattr(torch, dname),
                                        lens.tolist(), capacity=4096, d=d, hkv=hkv)
                for kname, what, fn, plain, pools in (
                        ("paged_decode", "B5", pa.paged_attention_decode,
                         pa.paged_attention_decode_plain, (kp[0], vp[0], lens, table)),
                        ("quant_paged_decode", f"B8 {dname}", qz.paged_attention_decode_quantized,
                         qz.paged_attention_decode_quantized_plain, (kq, vq, lens, tq))):
                    out = fn(q, *pools, logit_softcap=cap)
                    again = fn(q, *pools, logit_softcap=cap)
                    ref = plain(q.float(), *pools, logit_softcap=cap)
                    label = f"{what} D {d} group {hq // hkv} cap {cap:g} page_size {ps}"
                    held(kname, label, d, out, ref)
                    check(bool((out[0] == 0).all()), f"{label}: row of length 0 is exactly 0")
                    check(torch.equal(out, again), f"{label}: a second call repeats bit for bit")
                del kq, vq
                if hkv == 1:
                    continue
                s = 512 if ps == 16 else 100
                off = torch.tensor([0, 512, 3000, 0], dtype=torch.int32, device="cuda")
                kvl = torch.tensor([s, 512 + s, 3000 + s, 0], dtype=torch.int32, device="cuda")
                kp, vp, table = paged_pool(torch, randn, gen, ps, rows=4, capacity=4096,
                                           layers=1, d=d)
                poison_past(torch, kp, table, kvl)
                poison_past(torch, vp, table, kvl)
                q = randn(4, s, hq, d).transpose(1, 2)  # the model's [B, S, H, D] view
                for w in ((None, WINDOW) if d == 256 else (None,)):
                    out = pa.paged_attention_extend(q, kp[0], vp[0], off, kvl, table, window=w,
                                                    logit_softcap=cap)
                    ref = pa.paged_attention_extend_plain(q.float(), kp[0], vp[0], off, kvl,
                                                          table, window=w, logit_softcap=cap)
                    held("paged_extend", f"B6 D {d} cap {cap:g} page_size {ps} S {s} window {w}",
                         d, out, ref)
                    check(bool((out[3] == 0).all()), "B6 inactive row is exactly 0")
                del kp, vp
                # B9 over the same rows: int8 pages of 16, e4m3 pages of 128.
                dname = "int8" if ps == 16 else "float8_e4m3fn"
                kq, vq, tq = quant_pool(torch, qz, randn, gen, ps, 4, getattr(torch, dname),
                                        kvl.tolist(), capacity=4096, d=d)
                for w in ((None, WINDOW) if d == 256 else (None,)):
                    out = qz.paged_attention_extend_quantized(q, kq, vq, off, kvl, tq, window=w,
                                                              logit_softcap=cap)
                    ref = qz.paged_attention_extend_quantized_plain(q.float(), kq, vq, off, kvl,
                                                                    tq, window=w,
                                                                    logit_softcap=cap)
                    held("quant_paged_extend", f"B9 {dname} D {d} cap {cap:g} page_size {ps} "
                         f"S {s} window {w}", d, out, ref)
                    check(bool((out[3] == 0).all()), "B9 inactive row is exactly 0")
                del kq, vq

    # The append at D 256: decode rows (one inactive, one past the table)
    # and a 100-token chunk; exactly what the plain masked scatter writes.
    for s, starts, act in ((1, [0, 5, 127, 4096, 37, 256, 1, 9], [1, 1, 1, 1, 0, 1, 1, 1]),
                           (100, [0, 13, 4096 - 40, 3], [1, 1, 1, 0])):
        b = len(starts)
        kp, vp, table = paged_pool(torch, randn, gen, 16, rows=b, capacity=4096, layers=1, d=256)
        new_k, new_v = (randn(b, s, 8, 256).transpose(1, 2) for _ in "kv")
        lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
        active = torch.tensor(act, dtype=torch.bool, device="cuda")
        ref_k, ref_v = kp[0].clone(), vp[0].clone()
        paged_cache.paged_append_layer(kp[0], vp[0], new_k, new_v, table, lengths, active)
        paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, table, lengths, active)
        same = torch.equal(kp[0], ref_k) and torch.equal(vp[0], ref_v)
        record("paged_append", 256, max(max_err(kp[0], ref_k), max_err(vp[0], ref_v)))
        print(f"  append D 256, S {s}, starts {starts}: identical to plain: {same}")
        check(same, "append kernel at D 256 writes exactly what the plain scatter writes")
        # QA at D 256 over the same rows, paged (int8) and into the
        # contiguous cache (e4m3); exactly what quantize_kv + the indexed
        # write writes.
        from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV
        kq, vq, tq = quant_pool(torch, qz, randn, gen, 16, b, torch.int8, [4096] * b,
                                capacity=4096, d=256)
        cont = [qz.quantize_kv(randn(b, 8, 4096 + s, 256), torch.float8_e4m3fn) for _ in "kv"]
        for mode, (kc, vc), tbl, act_ in (("paged int8", (kq, vq), tq, active),
                                          ("contiguous e4m3", cont, None, None)):
            ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (kc, vc)]
            qz.quantize_append(new_k, new_v, kc, vc, lengths, tbl, act_)
            qz.quantize_append_plain(new_k, new_v, *ref, lengths, tbl, act_)
            same = all(torch.equal(g.values.view(torch.uint8), w.values.view(torch.uint8))
                       and torch.equal(g.scales.view(torch.int32), w.scales.view(torch.int32))
                       for g, w in zip((kc, vc), ref))
            record("quant_append", 256, 0.0 if same else float("inf"))
            print(f"  QA D 256 {mode}, S {s}, starts {starts}: bit-identical to plain: {same}")
            check(same, "QA at D 256 writes exactly what quantize_kv + the indexed write writes")
        del kq, vq, cont
    torch.cuda.empty_cache()


def phase_gemma2(torch, cfg, params, kernels, path_counts):
    """Gemma-2-9B: teacher-forced prefill (every GEMMA2_KEEP-th position and
    the last) and decode-step logits of the kernel route against the plain
    route, a row at a time; greedy generation over a bf16 cache (B2 on the
    21 windowed layers, P on the 21 full ones; D1 + D2 per layer and step)
    and its prefill and decode times; over int8 and e4m3 caches the decode
    step, kernel route (QA, B7 + D2 at D 256 with the cap) against the plain
    route, and greedy generation with its launch counts
    (`quantized_greedy`); then the serving engine in runs G1
    (whole-prompt admission, page_size 128), G2 (chunked admission of 512,
    page_size 16) and G3 (G2 over int8 pages: B9, B8 and QA at D 256 with
    the cap) over `mistral_requests`, every token teacher-forced."""
    label = "Gemma-2-9B"
    keep = torch.arange(0, GEMMA2_PROMPT, GEMMA2_KEEP).tolist() + [GEMMA2_PROMPT - 1]
    ids, _, results = phase_family(torch, cfg, params, 9, GEMMA2_B, GEMMA2_PROMPT, GEMMA2_NEW,
                                   kernels, path_counts, label, keep=keep)
    results.update(quantized_greedy(torch, cfg, params, ids, GEMMA2_NEW, kernels, path_counts,
                                    label, ("int8", "float8_e4m3fn")))
    results["prompt lookup"] = gemma2_prompt_lookup(torch, cfg, params, kernels, path_counts,
                                                    label)
    results.update(serve_long_requests(torch, cfg, params, kernels, path_counts, label, {
        "G1 whole-prompt": MISTRAL_SERVING_RUNS["M1 whole-prompt"],
        "G2 chunked": MISTRAL_SERVING_RUNS["M2 chunked"],
        "G3 chunked int8": {**MISTRAL_SERVING_RUNS["M2 chunked"], "kv_dtype": "int8"}}))
    return results


GEMMA2_LOOKUP_SEGMENT, GEMMA2_LOOKUP_REPEATS = 64, 8


def gemma2_prompt_lookup(torch, cfg, params, kernels, path_counts, label):
    """`prompt_lookup_generate` (ngram 2, gamma GAMMA) over a bf16 cache at
    B GEMMA2_B on prompts that repeat a seeded 64-token segment 8 times,
    GEMMA2_NEW new tokens: every round's verify extend runs B4 at D 256 with
    the soft cap (layers x rounds launches), the prefill P on every layer
    (the window of 4096 cannot bind at 512); every token teacher-forced
    through one contiguous prefill."""
    import numpy as np
    from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate

    n = cfg.num_layers
    seg = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                             (GEMMA2_B, GEMMA2_LOOKUP_SEGMENT))
    ids = torch.from_numpy(np.tile(seg, (1, GEMMA2_LOOKUP_REPEATS))).to("cuda")
    (tokens, stats), wall, counts = counted_run(torch, kernels, lambda: prompt_lookup_generate(
        params, cfg, ids, GEMMA2_NEW, gamma=GAMMA, ngram=2, return_stats=True))
    path_counts[f"{label} prompt lookup"] = counts
    rounds = stats["rounds"]
    share = stats["accepted_drafts"] / (rounds * GAMMA * GEMMA2_B)
    print(f"  {label} prompt lookup B{GEMMA2_B} prompt {ids.shape[1]} new {GEMMA2_NEW} gamma "
          f"{GAMMA}: {wall:.3f} s, rounds {rounds}, accepted drafts {stats['accepted_drafts']} "
          f"(share {share:.4f}), launches { {k: c for k, c in counts.items() if c} }")
    check(tuple(tokens.shape) == (GEMMA2_B, GEMMA2_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), f"{label} prompt lookup: tokens")
    check_counts(counts, {**prefill_counts(cfg, ids.shape[1]), "flash_chunked": n * rounds},
                 f"{label} prompt lookup")
    near, top = [], []
    for row in range(GEMMA2_B):
        a, b = teacher_forced(torch, cfg, params, ids[row].tolist(), tokens[row].tolist())
        near += a
        top += b
    print(f"  {label} prompt lookup teacher-forced: {sum(near)}/{len(near)} tokens within "
          f"{LOGIT_MAX_TOL} of the top logit, argmax share {sum(top) / len(top):.4f}")
    check(all(near), f"{label} prompt lookup: every token within {LOGIT_MAX_TOL} of the top logit")
    check(sum(top) / len(top) >= ARGMAX_SHARE_MIN,
          f"{label} prompt lookup: argmax share >= {ARGMAX_SHARE_MIN}")
    return {"wall_s": wall, "tokens_per_s": GEMMA2_B * GEMMA2_NEW / wall, "rounds": rounds,
            "accepted_drafts": stats["accepted_drafts"], "acceptance_share": share,
            "teacher_forced_argmax_share": sum(top) / len(top)}


def flex_or_sdpa(torch, q, k, v, cap, window):
    """library_ms of P / B2 at Gemma-2-9B shapes: one call of
    `flex_attention` (compiled) with the tanh soft cap as its score_mod and
    the causal (windowed) mask as a block mask, GQA by enable_gqa; where it
    does not compile, SDPA without the soft cap over GQA-expanded K/V.
    Returns (callable, label)."""
    f = torch.nn.functional
    s, d = q.shape[2], q.shape[3]
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        def mask_mod(b, h, qi, ki):
            m = ki <= qi
            return m & (ki > qi - window) if window else m

        block_mask = create_block_mask(mask_mod, None, None, s, s, device="cuda")
        flex = torch.compile(flex_attention)

        def call():
            return flex(q, k, v, score_mod=score_mod, block_mask=block_mask, enable_gqa=True,
                        scale=d ** -0.5)

        call()
        torch.cuda.synchronize()
        return call, "flex_attention (compiled) with the tanh soft cap as score_mod"
    except Exception as exc:  # a yardstick only: the port never calls it
        print(f"  flex_attention did not compile ({type(exc).__name__}): library_ms is SDPA "
              "without the soft cap")
        rep = q.shape[1] // k.shape[1]
        kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window) if window
                                            else True)
        return (lambda: f.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
                "SDPA without the soft cap (flex_attention did not compile), GQA expanded")


def gemma2_rows(torch, ops, gen):
    """The `gemma2` entries of the P, B2, D1, D2, B7, B5, B6, B8, B9, QA and
    append rows, at Gemma-2-9B shapes with the soft cap 50: P and B2 at the
    greedy prefill (B 2, S 4608; B2 with W 4096), D1 / D2 at the greedy
    middle decode step (B 2, 4624 of 4640 positions, a full layer), B7 + D2
    there over int8 and (its "e4m3" entry) e4m3 values, B5 at
    run G1's decode (4 slots, page_size 128) and B8 there over int8 pages,
    QA at run G3's decode (one token a row into int8 pages of 16), B6 at run
    G2's extend (4 rows of 512, page_size 16, on a full layer) and B9 there
    over int8 pages (run G3's), the append at G1's decode; B4 at the verify
    round of 4j's prompt lookup (B 2, S 5, the default capacity 550,
    q_offset 539) and, under "chunk", at a chunk (B 2, S 256, capacity 4640,
    q_offset 4096 / 4352); B12 over 3g's 32 packed
    sequences (causal). library_ms: see `flex_or_sdpa` for P / B2; SDPA
    without the soft cap over a contiguous copy for B5 / B6 (dequantized for
    B7 / B8 / B9; the copy not timed), over the contiguous cache with the extend mask
    for B4, over the padded batch for B12; `index_copy_` for the append;
    null for D2 and QA (no call merges split partials or quantizes); D1's is
    one SDPA call over the length-masked cache (GQA expanded, without the
    cap) against D1 + D2 together ("library_of": "D1 + D2"). Bounds count
    the visible (query, key) pairs."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.runtime import paged_cache
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    flash_fwd, flash_decode, pa = ops["flash_fwd"], ops["flash_decode"], ops["paged_attention"]
    qz = ops["quantized"]
    f = torch.nn.functional
    hq, hkv, d, cap, w = 16, 8, 256, 50.0, WINDOW
    rep, scale = hq // hkv, d ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def measure(fn, plain, library, ops_, nbytes, peak, shape, iters=20, plain_iters=5):
        return {"shape": shape, "ms": cuda_time_ms(fn, iters), "call_ms": call_time_ms(fn, iters),
                "plain_ms": cuda_time_ms(plain, plain_iters),
                "library_ms": None if library is None else cuda_time_ms(library, iters),
                **bound(ops_, nbytes, peak)}

    rows = {}
    b, s = GEMMA2_B, GEMMA2_PROMPT
    q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
    for name, win in (("flash_fwd", None), ("flash_fwd_window", w)):
        pairs = sum(min(r + 1, win or s) for r in range(s))
        library, lib_label = flex_or_sdpa(torch, q, k, v, cap, win)
        rows[name] = measure(
            lambda: flash_fwd.flash_attention_fwd(q, k, v, scale, True, win, cap),
            lambda: flash_fwd.flash_attention_fwd_plain(q, k, v, scale, True, win, cap),
            library, 4 * b * hq * pairs * d, 2 * (2 * q.numel() + k.numel() + v.numel()),
            PEAK_BF16, f"B {b}, S {s}, window {win}, Hq {hq}, Hkv {hkv}, D {d}, soft cap {cap:g}; "
            f"library_ms: {lib_label}", iters=10, plain_iters=3)
        del library
    del q, k, v
    torch.cuda.empty_cache()

    cap_len, live = GEMMA2_CAPACITY, GEMMA2_PROMPT + GEMMA2_NEW // 2
    kc, vc, qd = randn(b, hkv, cap_len, d), randn(b, hkv, cap_len, d), randn(b, hq, 1, d)
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    splits = dispatch.decode_num_splits(b, hkv, cap_len, d)
    acc, m, l = flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits, None, cap)
    part_bytes = 4 * (acc.numel() + m.numel() + l.numel())
    shape = f"B {b}, cache {cap_len}, lengths {live}, splits {splits}, D {d}, soft cap {cap:g}"
    kcr, vcr = (x.repeat_interleave(rep, dim=1) for x in (kc, vc))
    dmask = (torch.arange(cap_len, device="cuda") < live)[None, None, None, :]
    rows["decode_partials"] = measure(
        lambda: flash_decode.decode_partials(qd, kc, vc, lengths, scale, splits, None, cap),
        lambda: flash_decode.decode_partials_plain(qd, kc, vc, lengths, scale, splits, None, cap),
        lambda: f.scaled_dot_product_attention(qd, kcr, vcr, attn_mask=dmask),
        4 * b * hq * live * d, 2 * qd.numel() + 2 * 2 * b * hkv * live * d + 4 * b,
        PEAK_BF16, shape + "; library_ms: SDPA without the soft cap", 50, 10)
    rows["decode_partials"].update(
        library_of=LIBRARY_OF_D1, with_combine_ms=cuda_time_ms(
            lambda: flash_decode.flash_attention_decode(qd, kc, vc, kv_length=lengths,
                                                        logit_softcap=cap), 50))
    del kcr, vcr
    # B7 + D2 over the same keys quantized to int8 (the row) and e4m3 (its
    # "e4m3" entry); library_ms: SDPA over a dequantized bf16 copy without
    # the cap.
    for vname in ("int8", "float8_e4m3fn"):
        k8, v8 = (qz.quantize_kv(x, getattr(torch, vname)) for x in (kc, vc))
        kd, vd = (qz.dequantize_kv(x, torch.bfloat16).repeat_interleave(rep, dim=1)
                  for x in (k8, v8))
        entry = measure(
            lambda: qz.flash_attention_decode_quantized(qd, k8, v8, lengths, logit_softcap=cap),
            lambda: qz.flash_attention_decode_quantized_plain(qd, k8, v8, lengths,
                                                              logit_softcap=cap),
            lambda: f.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask),
            4 * b * hq * live * d, 2 * 2 * qd.numel() + 2 * b * hkv * live * (d + 4) + 4 * b,
            PEAK_BF16, f"{shape}, {vname}; ms includes D2; library_ms: SDPA over a dequantized "
            "copy without the soft cap", 50, 10)
        if vname == "int8":
            rows["quant_decode"] = entry
        else:
            rows["quant_decode"]["e4m3"] = entry
        del k8, v8, kd, vd
    rows["decode_combine"] = measure(
        lambda: flash_decode.decode_combine(acc, m, l, torch.bfloat16),
        lambda: flash_decode.decode_combine_plain(acc, m, l, torch.bfloat16),
        None, 4 * acc.numel(), part_bytes + 2 * qd.numel(), PEAK_F32, shape, 50, 10)
    del kc, vc

    reqs = mistral_requests(256000)  # Gemma-2-9B's vocabulary
    lens_list = [len(p) + 24 for _, p, _ in reqs[:4]]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    b, ps, pps = 4, 128, 40
    kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=pps * ps, layers=1, d=d)
    kp, vp = kp[0], vp[0]
    q = randn(b, hq, 1, d)
    pos = torch.arange(pps * ps, device="cuda")[None, :]
    pmask = (pos < lens[:, None])[:, None, None, :]
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    live = sum(lens_list)
    tables = 4 * (b + sum(-(-n // ps) for n in lens_list))
    shape = (f"B {b}, page_size {ps}, lengths {lens_list}, splits "
             f"{dispatch.decode_num_splits(b, hkv, pps * ps, d)}, D {d}, soft cap {cap:g} "
             "(a full layer); ms includes D2; library_ms: SDPA without the soft cap")
    rows["paged_decode"] = measure(
        lambda: pa.paged_attention_decode(q, kp, vp, lens, table, logit_softcap=cap),
        lambda: pa.paged_attention_decode_plain(q, kp, vp, lens, table, logit_softcap=cap),
        lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=pmask),
        4 * hq * live * d, 2 * q.numel() + 2 * 2 * hkv * live * d + tables + 2 * q.numel(),
        PEAK_BF16, shape, 50, 10)
    del kc, vc
    # B8 at G1's decode over int8 pages, and QA at G3's decode (one token a
    # row into int8 pages of 16).
    qz = ops["quantized"]
    k8, v8, table8 = quant_pool(torch, qz, randn, gen, ps, b, torch.int8, capacity=pps * ps, d=d)
    kd, vd = (qz._gather_dequantized(x, table8).to(torch.bfloat16).repeat_interleave(rep, dim=1)
              for x in (k8, v8))
    shape8 = (f"B {b}, page_size {ps}, lengths {lens_list}, splits "
              f"{dispatch.decode_num_splits(b, hkv, pps * ps, d)}, D {d}, soft cap "
              f"{cap:g}, int8 (a full layer); ms includes D2; library_ms: SDPA without the "
              "soft cap over a dequantized bf16 copy")
    rows["quant_paged_decode"] = measure(
        lambda: qz.paged_attention_decode_quantized(q, k8, v8, lens, table8, logit_softcap=cap),
        lambda: qz.paged_attention_decode_quantized_plain(q, k8, v8, lens, table8,
                                                          logit_softcap=cap),
        lambda: f.scaled_dot_product_attention(q, kd, vd, attn_mask=pmask),
        4 * hq * live * d, 2 * q.numel() + 2 * hkv * live * (d + 4) + tables + 2 * q.numel(),
        PEAK_BF16, shape8, 50, 10)
    del k8, v8, kd, vd
    k8, v8, table8 = quant_pool(torch, qz, randn, gen, 16, b, torch.int8, capacity=pps * 128, d=d)
    nk, nv = randn(b, 1, hkv, d).transpose(1, 2), randn(b, 1, hkv, d).transpose(1, 2)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    rows["quant_append"] = measure(
        lambda: qz.quantize_append(nk, nv, k8, v8, lens, table8, active),
        lambda: qz.quantize_append_plain(nk, nv, k8, v8, lens, table8, active),
        None, 0, 2 * 2 * nk.numel() + 2 * (nk.numel() + 4 * b * hkv) + 4 * 3 * b, PEAK_F32,
        f"B {b}, S 1, page_size 16, D {d}, int8; library_ms: null (no single call quantizes)",
        50, 10)
    del k8, v8
    nk, nv = randn(b, 1, hkv, d).transpose(1, 2), randn(b, 1, hkv, d).transpose(1, 2)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    flat = paged_cache.append_targets(table, lens, 1, ps)[0].view(-1)
    kflat, vflat = (flat_pool(x) for x in (kp, vp))
    krows, vrows = (x.permute(1, 0, 2, 3).reshape(hkv, b, d) for x in (nk, nv))

    def library_append():
        kflat.index_copy_(1, flat, krows)
        vflat.index_copy_(1, flat, vrows)

    rows["paged_append"] = measure(
        lambda: paged_cache.paged_append_layer(kp, vp, nk, nv, table, lens, active),
        lambda: paged_cache.paged_append_layer_plain(kp, vp, nk, nv, table, lens, active),
        library_append, 0, 2 * 2 * 2 * nk.numel() + 4 * 3 * b, PEAK_F32,
        f"B {b}, S 1, page_size {ps}, D {d}; library_ms is index_copy_ on K and on V", 50, 10)
    del kp, vp

    b, ps, pps, s = 4, 16, 320, 512
    offs = [3584, 4096, 4096, 4608]
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl = off + s
    q = randn(b, s, hq, d).transpose(1, 2)
    kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=pps * ps, layers=1, d=d)
    kp, vp = kp[0], vp[0]
    kc, vc = (pa.gather_pages(x, table).repeat_interleave(rep, dim=1) for x in (kp, vp))
    cols = torch.arange(pps * ps, device="cuda")[None, None, :]
    emask = ((cols <= off[:, None, None] + torch.arange(s, device="cuda")[None, :, None])
             & (cols < kvl[:, None, None]))[:, None]
    pairs = sum(s * o + s * (s + 1) // 2 for o in offs)
    rows["paged_extend"] = measure(
        lambda: pa.paged_attention_extend(q, kp, vp, off, kvl, table, logit_softcap=cap),
        lambda: pa.paged_attention_extend_plain(q, kp, vp, off, kvl, table, logit_softcap=cap),
        lambda: f.scaled_dot_product_attention(q, kc, vc, attn_mask=emask),
        4 * hq * d * pairs, 2 * 2 * q.numel() + 2 * 2 * hkv * d * int(kvl.sum())
        + 4 * (2 * b + sum(-(-int(n) // ps) for n in kvl.tolist())), PEAK_BF16,
        f"B {b}, S {s}, page_size {ps}, q_offset {offs}, D {d}, soft cap {cap:g} (a full "
        "layer); library_ms: SDPA without the soft cap", 10, 3)
    del kp, vp, kc, vc
    k8, v8, table8 = quant_pool(torch, qz, randn, gen, ps, b, torch.int8, capacity=pps * ps, d=d)
    kd, vd = (qz._gather_dequantized(x, table8).to(torch.bfloat16).repeat_interleave(rep, dim=1)
              for x in (k8, v8))
    rows["quant_paged_extend"] = measure(
        lambda: qz.paged_attention_extend_quantized(q, k8, v8, off, kvl, table8,
                                                    logit_softcap=cap),
        lambda: qz.paged_attention_extend_quantized_plain(q, k8, v8, off, kvl, table8,
                                                          logit_softcap=cap),
        lambda: f.scaled_dot_product_attention(q, kd, vd, attn_mask=emask),
        4 * hq * d * pairs, 2 * 2 * q.numel() + 2 * hkv * (d + 4) * int(kvl.sum())
        + 4 * (2 * b + sum(-(-int(n) // ps) for n in kvl.tolist())), PEAK_BF16,
        f"B {b}, S {s}, page_size {ps}, q_offset {offs}, D {d}, soft cap {cap:g}, int8 (a full "
        "layer); library_ms: SDPA without the soft cap over a dequantized bf16 copy", 10, 3)
    del k8, v8, kd, vd, emask
    torch.cuda.empty_cache()

    fc, fv = ops["flash_chunked"], ops["flash_varlen"]

    def extend_row(b, s, cap_len, offs, iters):
        q, k, v, off, kvl = chunked_inputs(torch, gen, torch.bfloat16, s, cap_len, offs, None,
                                           d, hq, hkv)
        kr, vr = (x.nan_to_num().repeat_interleave(rep, dim=1) for x in (k, v))
        cols = torch.arange(cap_len, device="cuda")[None, None, :]
        mask = ((cols <= off[:, None, None] + torch.arange(s, device="cuda")[None, :, None])
                & (cols < kvl[:, None, None]))[:, None]
        pairs = sum(s * o + s * (s + 1) // 2 for o in offs)
        return measure(
            lambda: fc.flash_attention_chunked(q, k, v, off, kvl, logit_softcap=cap),
            lambda: fc.flash_attention_chunked_plain(q, k, v, off, kvl, logit_softcap=cap),
            lambda: f.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
            4 * hq * d * pairs, 2 * 2 * q.numel() + 2 * 2 * hkv * d * sum(o + s for o in offs)
            + 2 * 4 * b, PEAK_BF16, f"B {b}, S {s}, capacity {cap_len}, q_offset {offs}, Hq "
            f"{hq}, Hkv {hkv}, D {d}, soft cap {cap:g}; library_ms: SDPA without the soft cap, "
            "causal-offset + length mask, GQA expanded", iters, 3)

    look = GEMMA2_LOOKUP_SEGMENT * GEMMA2_LOOKUP_REPEATS
    rows["flash_chunked"] = extend_row(GEMMA2_B, GAMMA + 1, look + GEMMA2_NEW + GAMMA + 2,
                                       [look + GEMMA2_NEW - GAMMA - 1] * GEMMA2_B, 50)
    rows["flash_chunked"]["chunk"] = extend_row(2, 256, GEMMA2_CAPACITY, [4096, 4352], 20)

    lens, _ = varlen_batch()
    q, k, v, cu, _ = varlen_inputs(torch, gen, lens, lens, hq, hkv, d)
    seg, pos = fv._seg_metadata(cu, q.shape[0])
    qp, kp, vp = (torch.zeros((len(lens), h, max(lens), d), dtype=torch.bfloat16, device="cuda")
                  for h in (hq, hkv, hkv))
    for i, n in enumerate(lens):
        a = int(cu[i])
        for dst, src in ((qp, q), (kp, k), (vp, v)):
            dst[i, :, :n] = src[a:a + n].transpose(0, 1)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    rows["flash_varlen"] = measure(
        lambda: fv.flash_attention_varlen(q, k, v, cu, causal=True, logit_softcap=cap),
        lambda: fv.flash_attention_packed_plain(q.transpose(0, 1), k.transpose(0, 1),
                                                v.transpose(0, 1), seg, seg, pos, pos,
                                                causal=True, logit_softcap=cap),
        lambda: f.scaled_dot_product_attention(qp, kp, vp, is_causal=True, enable_gqa=True),
        4 * d * hq * pairs, 2 * (2 * q.numel() + 2 * k.numel()) + 4 * 4 * q.shape[0], PEAK_BF16,
        f"{len(lens)} sequences of {min(lens)}-{max(lens)} tokens ({q.shape[0]} packed), causal, "
        f"Hq {hq}, Hkv {hkv}, D {d}, soft cap {cap:g}; library_ms: SDPA without the soft cap "
        "(is_causal, enable_gqa) over the padded batch", 10, 2)
    del q, k, v, qp, kp, vp
    torch.cuda.empty_cache()
    return rows


# Phase 3i / 5e: int8 scores (`score_dtype="int8"`): K8, then P-i8 (B2-i8
# where the window binds), each with its lse. (name, batch, hq, hkv, sq,
# skv, d, causal, window, cap, dtype, transposed views): Llama-3-8B
# attention at the main path's B 4 S 512 and at B 1 S 8192, where the score
# product weighs most; Mistral-7B's window (B2-i8); Gemma-2-9B's D 256 with
# the cap 50, also windowed; D 64, non-causal, Sq < Skv; f16 with rows of
# no key.
INT8_CASES = (
    ("Llama-3-8B B4 S512", 4, 32, 8, 512, 512, 128, True, None, None, "bfloat16", True),
    ("Llama-3-8B B1 S8192", 1, 32, 8, 8192, 8192, 128, True, None, None, "bfloat16", False),
    ("Mistral-7B B2 S5120 W4096", MISTRAL_B, 32, 8, MISTRAL_PROMPT, MISTRAL_PROMPT, 128, True,
     WINDOW, None, "bfloat16", True),
    ("Gemma-2-9B B2 S4608 cap 50", GEMMA2_B, 16, 8, GEMMA2_PROMPT, GEMMA2_PROMPT, 256, True,
     None, 50.0, "bfloat16", True),
    ("Gemma-2-9B W4096 cap 50", 1, 16, 8, GEMMA2_PROMPT, GEMMA2_PROMPT, 256, True, WINDOW, 50.0,
     "bfloat16", False),
    ("D64 non-causal Sq300 Skv1000", 1, 32, 8, 300, 1000, 64, False, None, None, "bfloat16",
     False),
    ("f16 Sq1000 Skv700 rows of no key", 1, 32, 8, 1000, 700, 128, True, None, None, "float16",
     True),
)
INT8_ORACLE_TOL = 5e-2  # int8 scores against bf16 ones: the JAX package's envelope
INT8_MIN_DIFF = 1e-4  # int8 scores must move the output: they do quantize
PEAK_I8 = 1979e12  # published H100 SXM dense int8 tensor-core rate


def by_kv_head(torch, fn, q, k, v, step=0, kv_dim=1):
    """fn over one kv head and its q heads at a time (`step`: that many q
    heads of a group at a time, a divisor of the group), concatenated over
    the heads (each part of a tuple): the plain versions at full width
    within the card's memory (64 q heads of one kv head x 8192 keys: 8 at a
    time). k / v hold their heads on axis `kv_dim` (a pool [Hkv, P, ps, D]:
    0)."""
    g = q.shape[1] // k.shape[kv_dim]
    step = step or g
    outs = [fn(q[:, h:h + step], k.narrow(kv_dim, h // g, 1), v.narrow(kv_dim, h // g, 1))
            for h in range(0, q.shape[1], step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x, 1) for x in zip(*outs))
    return torch.cat(outs, 1)


def int8_inputs(torch, gen, b, hq, hkv, sq, skv, d, dt, views):
    dtype = getattr(torch, dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if views:  # the model's [B, S, H, D] projections
        return (randn(b, sq, hq, d).transpose(1, 2), randn(b, skv, hkv, d).transpose(1, 2),
                randn(b, skv, hkv, d).transpose(1, 2))
    return randn(b, hq, sq, d), randn(b, hkv, skv, d), randn(b, hkv, skv, d)


def phase_int8_kernels(torch, flash_fwd, errs, cases=INT8_CASES, tags=None):
    """K8 bit-identical to its plain version; P-i8 / B2-i8 over `cases`
    against the plain int8 version (fp32 output, BF16_TOL; lse LSE_TOL),
    the fp32 oracle of bf16 scores (INT8_ORACLE_TOL), the bf16-score kernel
    (more than INT8_MIN_DIFF apart), each call repeated bit for bit. The
    errors at a head dim of `tags` ({d: tag}) also go to "<key> <tag>"."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for name, b, hq, hkv, sq, skv, d, causal, w, cap, dt, views in cases:
        tag = (tags or {}).get(d)
        q, k, v = int8_inputs(torch, gen, b, hq, hkv, sq, skv, d, dt, views)
        kw = dict(causal=causal, window=w, logit_softcap=cap)
        values, scales = flash_fwd.quantize_k_rows(k)
        want_v, want_s = flash_fwd.quantize_rows_plain(k)
        k8_same = torch.equal(values, want_v) and torch.equal(scales, want_s)
        note_err(errs, "quantize_k_rows", max(max_err(values, want_v), max_err(scales, want_s)),
                 tag)
        del values, scales, want_v, want_s
        out, lse = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True, score_dtype="int8",
                                                 **kw)
        again, lse_again = flash_fwd.flash_attention_fwd(q, k, v, return_lse=True,
                                                         score_dtype="int8", **kw)
        bare = flash_fwd.flash_attention_fwd(q, k, v, score_dtype="int8", **kw)
        same = torch.equal(out, again) and torch.equal(lse, lse_again) and torch.equal(out, bare)
        del again, lse_again, bare
        ref, ref_lse = by_kv_head(torch, lambda q_, k_, v_: flash_fwd.int8_attention_plain(
            q_, k_, v_, d ** -0.5, causal, w, cap, True, out_dtype=torch.float32), q, k, v)
        e = max_err(out, ref)
        fin = torch.isfinite(ref_lse)
        e_lse = (lse[fin] - ref_lse[fin]).abs().max().item() if bool(fin.any()) else 0.0
        lse_inf_same = torch.equal(fin, torch.isfinite(lse))
        del ref, ref_lse
        oracle = by_kv_head(torch, lambda q_, k_, v_: flash_fwd.flash_attention_fwd_plain(
            q_.float(), k_.float(), v_.float(), **kw), q, k, v)
        e_oracle = max_err(out, oracle)
        del oracle
        e_bf16 = max_err(out, flash_fwd.flash_attention_fwd(q, k, v, **kw))
        key = "flash_fwd_window_int8" if w and w < skv else "flash_fwd_int8"
        note_err(errs, key, e, tag)
        note_err(errs, f"{key} oracle", e_oracle, tag)
        note_err(errs, f"{key} lse", e_lse)
        what = (f"{'B2-i8' if key.endswith('window_int8') else 'P-i8'} {name} ({hq} / {hkv} "
                f"heads, D {d}, {dt}{', transposed views' if views else ''})")
        print(f"  {what}: K8 bit-identical {k8_same}; vs plain int8 {e:.3e}, lse {e_lse:.2e}; "
              f"vs fp32 oracle {e_oracle:.3e}; vs bf16 scores {e_bf16:.3e}; repeated bit for "
              f"bit: {same}")
        check(k8_same, f"{what}: K8 bit-identical to its plain version")
        check(bool(torch.isfinite(out).all()), f"{what}: finite")
        check(e <= BF16_TOL, f"{what}: within {BF16_TOL} of the plain int8 version")
        check(lse_inf_same and e_lse <= LSE_TOL, f"{what}: lse within {LSE_TOL}, same +inf rows")
        check(e_oracle <= INT8_ORACLE_TOL, f"{what}: within {INT8_ORACLE_TOL} of the fp32 oracle")
        check(e_bf16 > INT8_MIN_DIFF, f"{what}: differs from bf16 scores by > {INT8_MIN_DIFF}")
        check(same, f"{what}: a second call repeats output and lse bit for bit")
        if causal and sq > skv:
            check(bool((out[:, :, :sq - skv] == 0).all()), f"{what}: rows with no key are zeros")
        del q, k, v, out, lse
        torch.cuda.empty_cache()


def phase_int8_path(torch, api, flash_fwd, kernels, counts):
    """The API's dense prefill with score_dtype="int8" at full width: Llama-3-8B
    attention at B 4 S 512 (transposed views, causal) and Mistral-7B's
    window at B 2 S 5120, counted: K8 twice, P-i8 once, B2-i8 once, no
    bf16-score P / B2; each output against the plain int8 version."""
    gen = torch.Generator(device="cuda").manual_seed(4322)
    llama = int8_inputs(torch, gen, B, 32, 8, PROMPT, PROMPT, 128, "bfloat16", True)
    mistral = int8_inputs(torch, gen, MISTRAL_B, 32, 8, MISTRAL_PROMPT, MISTRAL_PROMPT, 128,
                          "bfloat16", True)
    outs, wall, launched = counted_run(torch, kernels, lambda: (
        api.flash_attention_forward(*llama, causal=True, score_dtype="int8"),
        api.flash_attention_forward(*mistral, causal=True, window=WINDOW, score_dtype="int8")))
    counts.update(launched)
    print(f"  api.flash_attention_forward(score_dtype='int8'): Llama B{B} S{PROMPT}, Mistral "
          f"B{MISTRAL_B} S{MISTRAL_PROMPT} W{WINDOW}: {wall:.3f} s, launches "
          f"{ {n: c for n, c in counts.items() if c} }")
    check_launched(counts, {"quantize_k_rows": 2, "flash_fwd_int8": 1, "flash_fwd_window_int8": 1},
                   "the int8-score API route")
    for (q, k, v), out, w in zip((llama, mistral), outs, (None, WINDOW)):
        ref = by_kv_head(torch, lambda q_, k_, v_: flash_fwd.int8_attention_plain(
            q_, k_, v_, 128 ** -0.5, True, w, None, False, out_dtype=torch.float32), q, k, v)
        e = max_err(out, ref)
        print(f"  API int8 route (window {w}): vs plain int8 {e:.3e}")
        check(e <= BF16_TOL, f"API int8 route (window {w}) within {BF16_TOL}")


def int8_entry(torch, flash_fwd, gen, b, hq, hkv, s, d, w, cap, shape, plain=True, iters=20):
    """The P-i8 (B2-i8 where `w` binds) entry of `int8_rows` at (B, Hq,
    Hkv, S, D), causal, over the model's transposed views, and K8's on its
    K: (kernel entry, K8 entry)."""
    from flash_attention_cute_tpu_torch.ops import _build
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    def pairs(b, sq, skv, causal, w):
        """Visible (query, key) pairs over the batch."""
        return b * sum(max(0, min(skv, m + skv - sq + 1 if causal else skv)
                           - (max(0, m + skv - sq - w + 1) if w else 0)) for m in range(sq))

    q, k, v = int8_inputs(torch, gen, b, hq, hkv, s, s, d, "bfloat16", True)
    q, k, v = (_build.rows(n, x) for n, x in (("q", q), ("k", k), ("v", v)))
    kw = dict(causal=True, window=w, logit_softcap=cap)
    k8, kscale = flash_fwd._quantize_k_padded(k)
    out = _build.empty_rows((b, hq, s, d), q.dtype, "cuda")
    win = _build.window_arg(w) if w and w < s else 0
    n = pairs(b, s, s, True, w) * hq
    nbytes = (2 * q.numel() + k8.numel() + 4 * kscale.numel() + 2 * v.numel()
              + 2 * out.numel())
    t_ops = 2 * d * n / PEAK_I8 + 2 * d * n / PEAK_BF16

    def kernel():
        flash_fwd.launch_int8(q, k8, kscale, v, out, None, d ** -0.5, True, win,
                              _build.softcap_arg(cap))

    e = {"shape": shape, "ms": cuda_time_ms(kernel, iters),
         "call_ms": call_time_ms(kernel, iters),
         "with_k8_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(
             q, k, v, score_dtype="int8", **kw), iters),
         "bf16_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, **kw), iters),
         "plain_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd_plain(
             q, k, v, score_dtype="int8", **kw), 3, 1) if plain else None,
         "library_ms": None,
         "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, t_ops),
         "bound_by": "operations" if t_ops >= nbytes / PEAK_BYTES else "bytes"}
    k_entry = {"shape": f"K of {shape}",
               "ms": cuda_time_ms(lambda: flash_fwd._quantize_k_padded(k), iters),
               "call_ms": call_time_ms(lambda: flash_fwd._quantize_k_padded(k), iters),
               "plain_ms": cuda_time_ms(lambda: flash_fwd.quantize_rows_plain(k), 5),
               "library_ms": None,
               **bound(3 * k.numel(), 3 * k.numel() + 4 * kscale.numel(), PEAK_F32)}
    del q, k, v, k8, kscale, out
    torch.cuda.empty_cache()
    return e, k_entry


def int8_rows(torch, flash_fwd, gen):
    """Kernel rows of P-i8 (at the main path's B 4 S 512; "long": B 1 S
    8192; "gemma2": Gemma-2-9B's B 2 S 4608, D 256, cap 50), B2-i8 (Mistral
    B 2 S 5120 W 4096) and K8 (the K of the P-i8 row; "long": of B 1 S 8192).
    "ms" / "call_ms" are the kernel alone (P-i8 / B2-i8 over K8's output),
    "with_k8_ms" the wrapper's call (K8 + the kernel, device time),
    "bf16_ms" the bf16-score P / B2 at the same inputs. Bounds: the bytes (q, K8's int8 K and scales, v, the
    output) at the memory rate, or QK^T at the int8 peak plus PV at the bf16
    peak, whichever is longer; K8's are its bytes. library_ms: null, no
    single PyTorch call computes attention over int8 scores or quantizes
    rows so."""
    def entry(*args, **kw):
        return int8_entry(torch, flash_fwd, gen, *args, **kw)

    p_i8, k8_row = entry(B, 32, 8, PROMPT, 128, None, None,
                         f"B {B}, S {PROMPT}, Hq 32, Hkv 8, D 128, causal (the main path's)")
    long_p, long_k = entry(1, 32, 8, 8192, 128, None, None, "B 1, S 8192, Hq 32, Hkv 8, D 128, "
                           "causal", plain=False, iters=10)
    gemma, _ = entry(GEMMA2_B, 16, 8, GEMMA2_PROMPT, 256, None, 50.0,
                     f"B {GEMMA2_B}, S {GEMMA2_PROMPT}, Hq 16, Hkv 8, D 256, causal, cap 50",
                     plain=False, iters=10)
    b2_i8, _ = entry(MISTRAL_B, 32, 8, MISTRAL_PROMPT, 128, WINDOW, None,
                     f"B {MISTRAL_B}, S {MISTRAL_PROMPT}, window {WINDOW}, Hq 32, Hkv 8, D 128",
                     iters=10)
    src = "flash_attention_cute_tpu_torch/csrc/flash_fwd.cu"
    return [
        {"name": "flash_fwd_int8", "route": "cuda", "source": src,
         "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:595", **p_i8,
         "long": long_p, "gemma2": gemma},
        {"name": "flash_fwd_window_int8", "route": "cuda", "source": src,
         "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:269", **b2_i8},
        {"name": "quantize_k_rows", "route": "cuda", "source": src,
         "replaces": "flash_attention_cute_tpu/ops/flash_fwd.py:79", **k8_row, "long": long_k},
    ]


# Phases 3j / 4m / 5f: head dims outside {64, 128, 256}. P / B2, D1 + D2,
# B5, B6 and the paged append run every multiple of 8 up to 256 in the
# layout of the next of 64, 128 and 256, TMA reading zeros past the true
# head dim. (head dim, q heads, kv heads, q's dtype): Phi-3-mini's D 96
# (32 / 32), H2O-Danube's D 80 (32 / 8), D 32 (a 64-column box over a
# 32-column row), D 160 (a box of D 256's layout wholly past the row; f16)
# and D 192; D 96 also windowed and capped.
ODD_HEAD_DIMS = ((96, 32, 32, "bfloat16"), (80, 32, 8, "bfloat16"), (32, 16, 4, "bfloat16"),
                 (160, 16, 8, "float16"), (192, 16, 4, "bfloat16"))
PHI3_LABEL = "phi3-widths"  # the launch-count path of phase 4m
PHI3_WINDOW = 2047  # Phi-3-mini's sliding_window, left out of the config (see phase_phi3)


def note_err(errs, key, e, tag=None):
    """Keep the largest error of `key` (and, with a tag, of "<key> <tag>")."""
    for k in (key, f"{key} {tag}") if tag else (key,):
        errs[k] = max(errs.get(k, 0.0), e)


def held_call(torch, errs, what, key, tag, fn, plain, *args, **kw):
    """Two calls of `fn` (bit for bit, finite over NaN tails) and the
    first's max |diff| against `plain` run on q's fp32 image (within
    BF16_TOL), noted under `key` (and "<key> <tag>")."""
    out, again = fn(*args, **kw), fn(*args, **kw)
    e = max_err(out, plain(args[0].float(), *args[1:], **kw))
    note_err(errs, key, e, tag)
    print(f"  {what}: max|diff| {e:.3e}")
    check(bool(torch.isfinite(out).all()), f"{what}: finite over NaN tails")
    check(torch.equal(out, again), f"{what}: a second call repeats bit for bit")
    check(e <= BF16_TOL, f"{what} within {BF16_TOL}")
    return out


def phase_odd_head_dims(torch, ops, paged_cache, errs, dims=ODD_HEAD_DIMS, tags=None):
    """Phase 3j (and 3o at `dims` PITCHED_HEAD_DIMS): each kernel of the
    head-dim rule at each case of `dims` against its fp32 plain version
    (3e-2), over NaN-poisoned pool tails and cache tails (pools and caches
    at the port's row pitch, q as the model's transposed views), every call
    repeated bit for bit; D1's partials against the plain partials (1e-2);
    the append bit-identical. A head dim of `tags` ({d: tag}, default D
    96's "phi3") is also windowed and capped, its errors also go to
    "<kernel> <tag>"."""
    tags = {96: "phi3"} if tags is None else tags
    flash_fwd, flash_decode, pa = ops["flash_fwd"], ops["flash_decode"], ops["paged_attention"]
    gen = torch.Generator(device="cuda").manual_seed(4390)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def note(key, e, tag):
        note_err(errs, key, e, tag)

    def held(what, key, tag, fn, plain, *args, **kw):
        return held_call(torch, errs, what, key, tag, fn, plain, *args, **kw)

    for d, hq, hkv, dt in dims:
        dtype = getattr(torch, dt)
        tag = tags.get(d)
        # (window, cap) variants: a tagged head dim also windowed and capped.
        variants = ((None, None), (100, None), (None, 50.0)) if tag else ((None, None),)
        for w, cap in variants:
            name = f"D {d} ({hq} / {hkv} heads, {dt}{f', window {w}' if w else ''}" \
                   f"{f', cap {cap:g}' if cap else ''})"
            q = randn(2, 333, hq, d, dtype=dtype).transpose(1, 2)  # the model's views
            k, v = (randn(2, 333, hkv, d, dtype=dtype).transpose(1, 2) for _ in "kv")
            held_prefill(torch, flash_fwd, errs, f"{'B2' if w else 'P'} {name} S 333", q, k, v,
                         True, w, cap, tag=tag)
            del q, k, v
            held_contiguous_decodes(torch, flash_decode, None, errs, gen, (
                (f"{name} capacity 577", d, hq, hkv, 577, w and 45, cap, dt),), (None,), tag)

            for ps in (16, 128):
                kp, vp, table = paged_pool(torch, lambda *sh: randn(*sh, dtype=dtype), gen, ps,
                                           rows=8, capacity=1024, d=d, hkv=hkv)
                full = table.shape[1] * ps
                lens = torch.tensor([0, 1, ps - 1, ps, ps + 1, full, 777, 2 * ps + 1],
                                    dtype=torch.int32, device="cuda")
                poison_past(torch, kp, table, lens)
                poison_past(torch, vp, table, lens)
                qd = randn(8, hq, 1, d, dtype=dtype)
                out = held(f"B5 + D2 {name} page_size {ps}", "paged_decode", tag,
                           pa.paged_attention_decode, pa.paged_attention_decode_plain, qd, kp[1],
                           vp[1], lens, table, window=w and 45, logit_softcap=cap)
                check(bool((out[0] == 0).all()), f"B5 {name}: row of length 0 is exactly 0")

                offs, s = [0, 61, 599], 130
                off = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
                kvl = torch.tensor([o + s for o in offs] + [0], dtype=torch.int32, device="cuda")
                kp, vp, table = paged_pool(torch, lambda *sh: randn(*sh, dtype=dtype), gen, ps,
                                           rows=4, capacity=1024, d=d, hkv=hkv)
                poison_past(torch, kp, table, kvl)
                poison_past(torch, vp, table, kvl)
                qe = randn(4, s, hq, d, dtype=dtype).transpose(1, 2)
                out = held(f"B6 {name} page_size {ps}, S {s}, q_offset {offs}", "paged_extend",
                           tag, pa.paged_attention_extend, pa.paged_attention_extend_plain, qe,
                           kp[1], vp[1], off, kvl, table, window=w, logit_softcap=cap)
                check(bool((out[3] == 0).all()), f"B6 {name}: inactive row is exactly 0")

                if w is None and cap is None:  # the append: decode rows and a chunk
                    for sa, starts in ((1, [0, 5, ps - 1, full, 37, 2 * ps, 1, 9]),
                                       (100, [0, ps - 3, full - 40, 3, 0, 0, 0, 0])):
                        ka, va = (pitched(torch, x.clone()) for x in (kp[1], vp[1]))
                        tab = torch.arange(1, 1 + 4 * (full // ps), dtype=torch.int32,
                                           device="cuda").view(4, -1).repeat(2, 1)
                        new_k = randn(8, sa, hkv, d, dtype=dtype).transpose(1, 2)
                        new_v = randn(8, sa, hkv, d, dtype=dtype).transpose(1, 2)
                        lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
                        active = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.bool,
                                              device="cuda")
                        ref_k, ref_v = ka.clone(), va.clone()
                        paged_cache.paged_append_layer(ka, va, new_k, new_v, tab, lengths,
                                                       active)
                        paged_cache.paged_append_layer_plain(ref_k, ref_v, new_k, new_v, tab,
                                                             lengths, active)
                        same = torch.equal(ka.nan_to_num(), ref_k.nan_to_num()) and \
                            torch.equal(va.nan_to_num(), ref_v.nan_to_num())
                        note("paged_append", 0.0 if same else float("inf"), tag)
                        print(f"  append {name} page_size {ps}, S {sa}: identical to plain: "
                              f"{same}")
                        check(same, f"append {name}: writes exactly what the plain scatter writes")
                del kp, vp
            if w is None and cap is None:  # D1's partials at 5 splits
                kc = randn(4, hkv, 577, d, dtype=dtype)
                vc = randn(4, hkv, 577, d, dtype=dtype)
                qd = randn(4, hq, 1, d, dtype=dtype)
                lengths = torch.tensor([577, 300, 37, 0], dtype=torch.int32, device="cuda")
                got = flash_decode.decode_partials(qd, kc, vc, lengths, d ** -0.5, 5)
                want = flash_decode.decode_partials_plain(qd, kc, vc, lengths, d ** -0.5, 5)
                e = max(max_err(x, y) for x, y in zip(got, want))
                note("decode_partials", e, tag)
                print(f"  D1 partials {name}, 5 splits: max|diff| {e:.3e}")
                check(e <= 1e-2, f"D1 partials {name} within 1e-2")
        torch.cuda.empty_cache()


def phase_odd_head_dims_quantized(torch, ops, errs, dims=ODD_HEAD_DIMS, tags=None,
                                  one_byte=True, formerly_refused=True):
    """Phase 3k (and 3o at PITCHED_ONE_BYTE_DIMS, and B4 alone, `one_byte`
    False, at PITCHED_HEAD_DIMS): B7 + D2, B8 + D2, B9 and QA over int8 and
    e4m3 values, and B4, at each case of `dims` (a head dim of `tags`, {d:
    tag}, default D 96's "phi3", also windowed and capped, its errors also
    under "<kernel> <tag>") against their fp32 plain versions (3e-2), over
    NaN-poisoned pool and cache tails, every call repeated bit for bit,
    length-0 and inactive rows exact zeros; QA's whole pools bit-identical
    to the plain version's. With `formerly_refused`: the calls refused
    before the pitched rows (a one-byte row of d % 16 == 8, D 40, in B7,
    B8, B9 and QA; D 100 in B4) launch once each; B7, B8, B9 and QA launch
    once each at D 264 (the wide layouts, over zero values: zero outputs)
    and refuse D 520 and D 0 before any launch; B4 and its partials launch
    once each at D 264 (the wide layout), held to their fp32 plain versions
    by `held_rows`, and refuse D 520 and D 0."""
    from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV

    tags = {96: "phi3"} if tags is None else tags
    quantized, flash_chunked = ops["quantized"], ops["flash_chunked"]
    gen = torch.Generator(device="cuda").manual_seed(4391)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def held(what, key, tag, fn, plain, *args, **kw):
        return held_call(torch, errs, what, key, tag, fn, plain, *args, **kw)

    for d, hq, hkv, dt in dims:
        dtype = getattr(torch, dt)
        tag = tags.get(d)
        variants = ((None, None), (100, None), (None, 50.0)) if tag else ((None, None),)
        for w, cap in variants:
            name = f"D {d} ({hq} / {hkv} heads, {dt}{f', window {w}' if w else ''}" \
                   f"{f', cap {cap:g}' if cap else ''})"
            if one_byte:
                held_contiguous_decodes(torch, None, quantized, errs, gen, (
                    (f"{name} capacity 577", d, hq, hkv, 577, w and 45, cap, dt),), QUANT_DTYPES,
                    tag)
            for ps in (16, 128) if one_byte else ():
                for vname in QUANT_DTYPES:
                    vdtype, what = getattr(torch, vname), f"{name} {vname} page_size {ps}"
                    full = 1024
                    lens = [0, 1, ps - 1, ps, ps + 1, full, 777, 2 * ps + 1]
                    k, v, table = quant_pool(torch, quantized, randn, gen, ps, len(lens), vdtype,
                                             lens, capacity=full, d=d, hkv=hkv)
                    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                    out = held(f"B8 + D2 {what}", "quant_paged_decode", tag,
                               quantized.paged_attention_decode_quantized,
                               quantized.paged_attention_decode_quantized_plain,
                               randn(len(lens), hq, 1, d, dtype=dtype), k, v, lengths, table,
                               window=w and 45, logit_softcap=cap)
                    check(bool((out[0] == 0).all()), f"B8 {what}: row of length 0 is exactly 0")

                    offs, s = [0, 61, 599], 130
                    off = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
                    kvl = torch.tensor([o + s for o in offs] + [0], dtype=torch.int32,
                                       device="cuda")
                    k, v, table = quant_pool(torch, quantized, randn, gen, ps, 4, vdtype,
                                             kvl.tolist(), capacity=full, d=d, hkv=hkv)
                    qe = randn(4, s, hq, d, dtype=dtype).transpose(1, 2)
                    out = held(f"B9 {what}, S {s}, q_offset {offs}", "quant_paged_extend", tag,
                               quantized.paged_attention_extend_quantized,
                               quantized.paged_attention_extend_quantized_plain, qe, k, v, off,
                               kvl, table, window=w, logit_softcap=cap)
                    check(bool((out[3] == 0).all()), f"B9 {what}: inactive row is exactly 0")
                    if w is not None or cap is not None:
                        continue
                    # QA: decode rows and a chunk, through the table (an
                    # inactive row, rows past the table) and into a
                    # contiguous cache; the whole pools against the plain
                    # version's.
                    for sa, starts in ((1, [0, 5, ps - 1, full, 37, 2 * ps, 1, 9]),
                                       (100, [0, ps - 3, full - 40, 3, 0, 0, 0, 0])):
                        b = len(starts)
                        nk, nv = (randn(b, sa, hkv, d, dtype=dtype).transpose(1, 2) for _ in "kv")
                        lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
                        active = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.bool,
                                              device="cuda")
                        kq, vq, tbl = quant_pool(torch, quantized, randn, gen, ps, b, vdtype,
                                                 capacity=full, d=d, hkv=hkv)
                        cont = [quantized.quantize_kv(randn(b, hkv, full + sa, d), vdtype)
                                for _ in "kv"]
                        for mode, (kc, vc), t_, a_ in (("paged", (kq, vq), tbl, active),
                                                       ("contiguous", cont, None, None)):
                            ref = [QuantizedKV(x.values.clone(), x.scales.clone()) for x in (kc, vc)]
                            quantized.quantize_append(nk, nv, kc, vc, lengths, t_, a_)
                            quantized.quantize_append_plain(nk, nv, *ref, lengths, t_, a_)
                            same = all(
                                torch.equal(g.values.view(torch.uint8), r.values.view(torch.uint8))
                                and torch.equal(g.scales.view(torch.int32),
                                                r.scales.view(torch.int32))
                                for g, r in zip((kc, vc), ref))
                            note_err(errs, "quant_append", 0.0 if same else float("inf"), tag)
                            print(f"  QA {what} {mode}, S {sa}: whole pools bit-identical to "
                                  f"plain: {same}")
                            check(same, f"QA {what} {mode}: writes exactly what the plain "
                                  "quantize_kv + indexed write writes, nothing else")
                        del cont, kq, vq
                    del k, v
            # B4: a verify round (one row of kv_length 0) and a chunk.
            for s, cap_len, offs, kvl in ((5, 582, [571, 0, 300, 13], [576, 0, 305, 18]),
                                          (256, 1100, [0, 77, 300, 768], None)):
                q, k, v, off, lens = chunked_inputs(torch, gen, dtype, s, cap_len, offs, kvl, d,
                                                    hq, hkv)
                out = held(f"B4 {name} S {s}, capacity {cap_len}, q_offset {offs}",
                           "flash_chunked", tag, flash_chunked.flash_attention_chunked,
                           flash_chunked.flash_attention_chunked_plain, q, k, v, off, lens,
                           causal=True, window=w, logit_softcap=cap)
                for i, n in enumerate(lens.tolist()):
                    if n == 0:
                        check(bool((out[i] == 0).all()), f"B4 {name}: a kv_length-0 row is 0")
                del q, k, v
        torch.cuda.empty_cache()

    if not formerly_refused:
        return
    # Refused before the pitched rows, now run: a one-byte row of 40 bytes
    # (d % 16 == 8, which breaks TMA's 16-byte stride rule unpitched) in B7,
    # B8, B9 and QA, the pools at the port's pitch of 48 bytes and the
    # contiguous cache through one padded copy (QA writes it in place: any
    # stride); D 100 in B4 (rows of 200 bytes: one padded copy each).
    counted = (quantized.QUANT_DECODE, quantized.QUANT_PAGED_DECODE,
               quantized.QUANT_PAGED_EXTEND, quantized.QUANT_APPEND, flash_chunked.CHUNKED,
               ops["flash_decode"].COMBINE)
    k, v, table = quant_pool(torch, quantized, randn, gen, 16, 2, torch.int8, capacity=64, d=40,
                             hkv=2)
    cache = quantized.quantize_kv(randn(2, 2, 64, 40), torch.int8)
    q40, rows = randn(2, 4, 1, 40), torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    q100, k100 = randn(2, 4, 5, 100), randn(2, 2, 64, 100)
    for what, i, call in (
            ("B7 at D 40 over int8", 0, lambda: quantized.flash_attention_decode_quantized(
                q40, cache, cache, rows)),
            ("B8 at D 40 over int8", 1, lambda: quantized.paged_attention_decode_quantized(
                q40, k, v, rows, table)),
            ("B9 at D 40 over int8", 2, lambda: quantized.paged_attention_extend_quantized(
                q40, k, v, rows, rows + 1, table)),
            ("QA at D 40 over int8", 3, lambda: quantized.quantize_append(
                q40[:, :2], q40[:, :2], cache, cache, rows)),
            ("B4 at D 100", 4, lambda: flash_chunked.flash_attention_chunked(
                q100, k100, k100, rows, rows + 5))):
        before = counted[i].launches
        out = call()
        torch.cuda.synchronize()
        print(f"  {what}: launched {counted[i].launches - before}")
        check(counted[i].launches == before + 1, f"{what} (refused before the pitched rows) "
              "launches its kernel once")
        check(out is None or bool(torch.isfinite(out).all()), f"{what}: finite")
    def kv(*shape):  # zero values, unit scales: no quantization of a 0-wide row
        return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device="cuda"),
                           torch.ones(shape[:-1], device="cuda"))

    quant_calls = [
        lambda d: quantized.flash_attention_decode_quantized(
            randn(2, 4, 1, d), kv(2, 2, 64, d), kv(2, 2, 64, d), rows, sm_scale=1.0),
        lambda d: quantized.paged_attention_decode_quantized(
            randn(2, 4, 1, d), kv(2, 9, 16, d), kv(2, 9, 16, d), rows, table, sm_scale=1.0),
        lambda d: quantized.paged_attention_extend_quantized(
            randn(2, 4, 1, d), kv(2, 9, 16, d), kv(2, 9, 16, d), rows, rows + 1, table,
            sm_scale=1.0),
        lambda d: quantized.quantize_append(randn(2, 2, 1, d), randn(2, 2, 1, d),
                                            kv(2, 2, 64, d), kv(2, 2, 64, d), rows)]
    # B7, B8, B9 and QA take 257-512 in the wide layouts (phase 5n): D 264
    # (one-byte rows of 264 bytes: padded copies of the caches they read)
    # launches each once, over zero values: zero outputs; D 520 and D 0 are
    # refused.
    before = [x.launches for x in counted[:4]]
    outs = [call(264) for call in quant_calls]
    torch.cuda.synchronize()
    print(f"  B7, B8, B9 and QA at D 264 (the wide layouts): launched "
          f"{[x.launches - n for x, n in zip(counted[:4], before)]}")
    check([x.launches - n for x, n in zip(counted[:4], before)] == [1, 1, 1, 1],
          "B7, B8, B9 and QA at D 264 launch their kernels once each")
    check(all(bool((out == 0).all()) for out in outs[:3]),
          "B7, B8 and B9 at D 264 over zero values: zero outputs")
    head_dims_refused(torch, ops, "B7, B8, B9 and QA (wide layouts up to 512)", quant_calls,
                      counted, dims=(520, 0))
    # B4 and its partials take 257-512 in the wide layout (phase 5m): D 264
    # launches each once, held to its fp32 plain version by `held_rows`; D
    # 520 and D 0 are refused.
    q264, k264, v264 = randn(2, 4, 5, 264), randn(2, 2, 64, 264), randn(2, 2, 64, 264)
    for partials in (False, True):
        kernel = flash_chunked.PARTIALS if partials else flash_chunked.CHUNKED
        before = kernel.launches
        out = flash_chunked.flash_attention_chunked(q264, k264, v264, rows, rows + 5,
                                                    return_partials=partials)
        torch.cuda.synchronize()
        what = "B4-partials" if partials else "B4"
        print(f"  {what} at D 264 (the wide layout): launched {kernel.launches - before}")
        check(kernel.launches == before + 1, f"{what} at D 264 launches its kernel once")
        held_rows(torch, errs, f"{what} at D 264", "flash_chunked_partials" if partials
                  else "flash_chunked", "wide", out,
                  flash_chunked.flash_attention_chunked_plain(q264.float(), k264, v264, rows,
                                                              rows + 5, return_partials=partials))
    head_dims_refused(torch, ops, "B4 and B4-partials (wide layout up to 512)", [
        lambda d, pa_=pa_: flash_chunked.flash_attention_chunked(
            randn(2, 4, 5, d), randn(2, 2, 64, d), randn(2, 2, 64, d), rows, rows + 5,
            sm_scale=1.0, return_partials=pa_) for pa_ in (False, True)],
        (*counted, flash_chunked.PARTIALS), dims=(520, 0))


def head_dims_refused(torch, ops, what, calls, counted, dims=(264, 0)):
    """Each of `calls` (a function of the head dim) at each of `dims` (D 264,
    above 256: ROADMAP.md A14, and D 0; D 520 for the kernels with the wide
    layout, which take 257-512) raises NotImplementedError naming the item
    before any launch of `counted`."""
    before = [x.launches for x in counted]
    for d in dims:
        for i, call in enumerate(calls):
            try:
                call(d)
                refused = ""
            except NotImplementedError as err:
                refused = str(err)
            check("ROADMAP.md A14" in refused,
                  f"{what}: call {i} at D {d} raises NotImplementedError naming ROADMAP.md A14")
    torch.cuda.synchronize()
    print(f"  {what} at D {' and D '.join(map(str, dims))}: refused, naming ROADMAP.md A14")
    check([x.launches for x in counted] == before, f"{what}: the refused calls launched nothing")


def phi3_mini_widths_config(layers=0):
    """A Llama-family config at the widths of microsoft/Phi-3-mini-4k-instruct
    (its config.json): 32 layers, hidden 3072, 32 q / 32 kv heads, head dim
    96, SwiGLU 8192, vocab 32064, RMSNorm eps 1e-5, RoPE theta 10000,
    untied embeddings. Its sliding_window of 2047 is left out: phase 4m's
    sequences all stay below 2047 keys, where it masks nothing."""
    import torch
    from flash_attention_cute_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                       num_layers=layers or 32, num_q_heads=32, num_kv_heads=32, head_dim=96,
                       max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
                       tie_word_embeddings=False, dtype=torch.bfloat16)


PHI3_SERVING_RUNS = {name: SERVING_RUNS[name] for name in ("A whole-prompt", "B chunked")}


def phase_phi3(torch, cfg, params, kernels, path_counts):
    """Phase 4m, at Phi-3-mini's widths (D 96): teacher-forced prefill and
    decode-step logits of the kernel route against the plain route, greedy
    generation (B 4, prompt 512, 64 new: P, then D1 + D2) over a bf16
    cache, then the serving engine in runs A (whole-prompt, page_size 128)
    and B (chunked 256, page_size 16) over `serving_requests` (B5 + D2, B6,
    the append, P at admission), every token teacher-forced; launch counts
    on paths "phi3-widths ...", each run's exact."""
    reqs = serving_requests(cfg)
    longest = max(max(len(p) + n for _, p, n in reqs), PROMPT + NEW)
    print(f"  sliding_window {PHI3_WINDOW} left out of the config: the longest sequence of "
          f"the phase holds {longest} keys, where a window of {PHI3_WINDOW} masks nothing")
    check(longest < PHI3_WINDOW, "every sequence of phase 4m stays below the window")
    ids, _, results = phase_family(torch, cfg, params, 10, B, PROMPT, NEW, kernels, path_counts,
                                   PHI3_LABEL)
    results.update(serve_long_requests(torch, cfg, params, kernels, path_counts, PHI3_LABEL,
                                       PHI3_SERVING_RUNS, reqs))
    counts: dict = {}
    for path, c in path_counts.items():
        if path.startswith(PHI3_LABEL):
            add_counts(counts, c)
    for name in ("flash_fwd", "decode_partials", "decode_combine", "paged_decode",
                 "paged_extend", "paged_append"):
        check(counts[name] > 0, f"{name} launched on path {PHI3_LABEL}")
    print(f"  {PHI3_LABEL}: prefill B{B} x {PROMPT} {results['prefill_ms']:.2f} ms, decode "
          f"{results['decode_ms_per_token']:.2f} ms/token; serving A / B wall "
          + " / ".join(f"{results[r]['wall_s']:.3f}" for r in PHI3_SERVING_RUNS) + " s, "
          + " / ".join(f"{results[r]['generated_tokens_per_s']:.1f}" for r in PHI3_SERVING_RUNS)
          + " tokens/s, peak " + " / ".join(f"{results[r]['peak_memory_gb']:.3f}"
                                             for r in PHI3_SERVING_RUNS) + " GB; launches "
          + ", ".join(f"{k} {counts[k]}" for k in sorted(counts) if counts[k]))
    print("[4n] Phi-3-mini widths over int8 / e4m3 caches and in speculation: greedy over "
          "int8 and e4m3 caches (QA, B7 + D2), serving runs D / E (QA, B8 + D2, B9), "
          "self-draft, 2-layer-draft and prompt-lookup speculation (B4, D1 + D2, P)")
    t0 = time.perf_counter()
    results["quantized_and_speculative"] = phase_phi3_quantized(
        torch, cfg, params, ids, results["greedy_wall_s"], kernels, path_counts)
    results["phase_4n_s"] = time.perf_counter() - t0
    print(f"  phase 4n: {results['phase_4n_s']:.1f} s")
    return results


PHI3_QUANT_SERVING_RUNS = {name: SERVING_RUNS[name]
                           for name in ("D int8 whole-prompt", "E e4m3 chunked")}
# The kernels of this slice, each of which must launch on phase 4n's paths.
PHI3_QUANT_KERNELS = ("quant_append", "quant_decode", "quant_paged_decode",
                      "quant_paged_extend", "flash_chunked")


def phase_phi3_quantized(torch, cfg, params, ids, greedy_wall_s, kernels, path_counts):
    """Phase 4n, at Phi-3-mini's widths and full depth, on paths
    "phi3-widths ...", each with its exact launch counts: (a) greedy
    generation (B 4, prompt 512, 64 new) over an int8 and an e4m3
    contiguous cache, the first decode step's kernel route against the plain
    route (`quantized_greedy`: QA, B7 + D2); (b) serving runs D (int8 pages
    of 128) and E (e4m3 pages of 16, chunked 256) over `serving_requests`
    (QA, B8 + D2, B9), every token teacher-forced over quantized pages; (c)
    self-draft, 2-layer-draft and prompt-lookup speculation at gamma 4 (B4,
    D1 + D2, P) as run 4e's for Llama, on a prompt drawn as run 4e draws
    its (numpy seed 0), every token teacher-forced, self-draft acceptance
    >= 0.75. QA, B7, B8, B9 and B4 each launch on these paths."""
    import numpy as np

    before = set(path_counts)
    results = quantized_greedy(torch, cfg, params, ids, NEW, kernels, path_counts, PHI3_LABEL,
                               QUANT_DTYPES)
    results.update(serve_long_requests(torch, cfg, params, kernels, path_counts, PHI3_LABEL,
                                       PHI3_QUANT_SERVING_RUNS, serving_requests(cfg)))
    spec_ids = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT))).to("cuda")
    results["speculative"] = phase_speculative(torch, cfg, params, spec_ids, kernels,
                                               path_counts, greedy_wall_s, f"{PHI3_LABEL} ",
                                               sampled=False)
    counts: dict = {}
    for path in set(path_counts) - before:
        check(path.startswith(PHI3_LABEL), f"phase 4n's path {path} is labelled {PHI3_LABEL}")
        add_counts(counts, path_counts[path])
    for name in PHI3_QUANT_KERNELS:
        check(counts.get(name, 0) > 0, f"{name} launched on phase 4n's paths")
    print(f"  {PHI3_LABEL} 4n launches: "
          + ", ".join(f"{k} {counts[k]}" for k in sorted(counts) if counts[k]))
    return results


def phi3_rows(torch, ops, gen):
    """Phases 5f and 5g: the "phi3" entries of the P, D1, D2, B5, B6 and
    append rows at phase 4m's shapes (Phi-3-mini's 32 / 32 heads, D 96): P
    at the greedy prefill (B 4, S 512), D1 / D2 at its middle decode step,
    B5 at run A's decode, B6 at run B's extend, the append at run A's
    decode (`dense_rows`, `paged_rows`); and of the B7, B8, B9, QA and B4
    rows at phase 4n's: B7 at the int8 greedy path's middle decode step, B8
    and QA at run D's decode, B9 at run E's extend (`quant_rows`), B4 at the
    last verify round of its speculation and at a chunk of 256
    (`chunked_rows`). library_ms: SDPA at D 96 (its flash backend takes D
    96), over a contiguous copy where the kernel reads pages, dequantized
    where it reads int8 / e4m3 values. Bounds count bytes and operations at
    D 96; P, D1, B4, B5, B6, B7, B8 and B9 run D 128's layout, so a quarter
    of their tile columns and products is padding, which counts against
    them (D2, the append and QA touch d columns only)."""
    out = widths_rows(torch, ops, gen, phi3_mini_widths_config(), chunked=True)
    for name, entry in out.items():
        entry.setdefault("shape", "phase 4m's")
        if name in ("flash_fwd", "decode_partials", "paged_decode", "paged_extend",
                    "flash_chunked", "quant_decode", "quant_paged_decode", "quant_paged_extend"):
            entry["padding"] = ("bound at D 96; the kernel runs in D 128's layout, a quarter of "
                                "its tile columns zeros")
    return out


# Phase 3l: head dims outside {64, 128, 256} in B13a / B13b and B12, each in
# the layout of the next of 64, 128 and 256 (D 8-56 in D 64's, 72-120 in D
# 128's, 136-248 in D 256's, whose second 128-column half is partial):
# (d, Hq, Hkv, dtype), GQA groups 1 and 4, bf16 and f16; and the shapes of
# each backward case, (Sq, Skv, causal, window).
ODD_TRAINING_DIMS = ((8, 16, 16, "bfloat16"), (24, 32, 8, "float16"), (40, 16, 16, "bfloat16"),
                     (96, 32, 32, "bfloat16"), (136, 16, 4, "float16"),
                     (200, 16, 16, "bfloat16"), (248, 16, 4, "bfloat16"))
ODD_TRAINING_SHAPES = ((333, 333, True, None), (256, 517, True, 100), (517, 256, False, None))
ODD_PACKED_LENS = ([333, 1, 190, 517, 64], [400, 17, 190, 600, 200])  # q, and kv longer


def phase_odd_head_dims_training(torch, ops, errs, rel_errs, dims=ODD_TRAINING_DIMS, tags=None,
                                 formerly_refused=True):
    """Phase 3l (and 3o at PITCHED_TRAINING_DIMS): B13a / B13b and B12 at
    each case of `dims` against their plain versions. The backward over the model's transposed views and
    a non-contiguous dO, fed the kernel forward's o and lse, causal,
    windowed with Sq < Skv and non-causal with Sq > Skv, within
    GRAD_REL_TOL of the plain backward (max |diff| / max |plain|), B13a
    also forced into 3 parts (within SPLIT_REL_TOL of one pass) and into
    one pass (within GRAD_REL_TOL of plain); B12 over a packed batch
    causal, with kv longer and a window of 100, and full, within BF16_TOL;
    every call repeated bit for bit. With `formerly_refused`: D 100,
    refused before the pitched rows, runs the backward, the autograd op and
    B12 once each; D 520 and D 0 are refused by the backward and the
    autograd op (which take 257-512 in the layout of 512, phase 5o) and by
    B12 (its wide layout, phase 5l), naming ROADMAP.md A14, with no
    launch. The errors at a head dim of `tags` ({d:
    tag}, default D 96's "phi3") also go to "<kernel> <tag>"."""
    tags = {96: "phi3"} if tags is None else tags
    flash_fwd, flash_bwd, flash_varlen = ops["flash_fwd"], ops["flash_bwd"], ops["flash_varlen"]
    from flash_attention_cute_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda").manual_seed(4392)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def cu(lens):
        return torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)

    for d, hq, hkv, dt in dims:
        dtype = getattr(torch, dt)
        tag = tags.get(d)
        for sq, skv, causal, window in ODD_TRAINING_SHAPES:
            name = (f"D {d} ({hq} / {hkv} heads, {dt}) Sq {sq} Skv {skv}, "
                    f"{'causal' if causal else 'non-causal'}{f', window {window}' if window else ''}")
            q = randn(1, sq, hq, d, dtype=dtype).transpose(1, 2)
            k, v = (randn(1, skv, hkv, d, dtype=dtype).transpose(1, 2) for _ in "kv")
            do = randn(1, sq, hq, d, dtype=dtype).transpose(1, 2)
            o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                   return_lse=True)
            before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
            got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
            again = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                                  window=window)
            torch.cuda.synchronize()
            check((flash_bwd.DKV.launches - before[0], flash_bwd.DQ.launches - before[1]) == (2, 2),
                  f"B13 {name}: one launch each of B13a and B13b a call")
            check(all(torch.equal(a, b2) for a, b2 in zip(got, again)),
                  f"B13 {name}: a second call gives bit-identical dq / dk / dv")
            want = flash_bwd.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do, lse,
                                                       causal=causal, window=window)
            rel = [rel_err(a, w) for a, w in zip(got, want)]
            for kname, idx in (("flash_bwd_dq", (0,)), ("flash_bwd_dkv", (1, 2))):
                note_err(errs, kname, max(max_err(got[i], want[i]) for i in idx), tag)
                note_err(rel_errs, kname, max(rel[i] for i in idx), tag)
            delta = (do.float() * o.float()).sum(-1)
            parts = {}
            for splits in (3, 1):
                parts[splits] = tuple(_build.empty_rows(g.shape, g.dtype, g.device)
                                      for g in got[1:])
                flash_bwd.launch(flash_bwd.DKV, q, k, v, do, lse, delta, *parts[splits],
                                 d ** -0.5, causal, window or 0, splits=splits)
            torch.cuda.synchronize()
            e_split = max(rel_err(parts[3][i], parts[1][i]) for i in (0, 1))
            e_one = max(rel_err(parts[1][i], want[1 + i]) for i in (0, 1))
            print(f"  B13 {name}: dq / dk / dv max|diff| / max|plain| "
                  + " / ".join(f"{r:.2e}" for r in rel)
                  + f"; B13a in 3 parts against one pass {e_split:.2e}, one pass against plain "
                  f"{e_one:.2e}; repeated bit for bit")
            check(all(bool(torch.isfinite(g).all()) for g in got), f"B13 {name}: finite")
            check(max(rel) <= GRAD_REL_TOL, f"B13 {name}: within {GRAD_REL_TOL} (relative)")
            check(e_split <= SPLIT_REL_TOL,
                  f"B13a {name}: 3 parts within {SPLIT_REL_TOL} of one pass")
            check(e_one <= GRAD_REL_TOL, f"B13a {name}: one pass within {GRAD_REL_TOL} of plain")
            del q, k, v, do, o, lse, got, again, want, parts, delta
        lens_q, lens_kv = ODD_PACKED_LENS
        for what, lk, kw in (("causal", lens_q, {"causal": True}),
                             ("kv longer, window 100", lens_kv, {"causal": True, "window": 100}),
                             ("full", lens_q, {})):
            q = randn(sum(lens_q), hq, d, dtype=dtype)
            k, v = (randn(sum(lk), hkv, d, dtype=dtype) for _ in "kv")
            before = flash_varlen.VARLEN.launches
            out = flash_varlen.flash_attention_varlen(q, k, v, cu(lens_q), cu(lk), **kw)
            again = flash_varlen.flash_attention_varlen(q, k, v, cu(lens_q), cu(lk), **kw)
            torch.cuda.synchronize()
            ref = varlen_plain(torch, flash_varlen, q, k, v, cu(lens_q), cu(lk), **kw)
            e = max_err(out, ref)
            note_err(errs, "flash_varlen", e, tag)
            name = f"B12 D {d} ({hq} / {hkv} heads, {dt}), {len(lens_q)} sequences, {what}"
            print(f"  {name}: max|diff| {e:.3e}")
            check(flash_varlen.VARLEN.launches == before + 2, f"{name}: one launch a call")
            check(bool(torch.isfinite(out).all()) and torch.equal(out, again),
                  f"{name}: finite, repeated bit for bit")
            check(e <= BF16_TOL, f"{name} within {BF16_TOL}")
            del q, k, v, out, again, ref
        torch.cuda.empty_cache()

    if not formerly_refused:
        return
    # D 100, refused before the pitched rows, now runs (rows of 104, its
    # views through one padded copy each); D 520 and D 0 stay refused by
    # the backward and the autograd op (phase 5o runs the layout of 512)
    # and by B12 (phase 5l runs its wide layout).
    counted = (flash_fwd.PREFILL, flash_fwd.WINDOWED_PREFILL, flash_bwd.DKV, flash_bwd.DQ,
               flash_varlen.VARLEN)
    one = torch.tensor([0, 64], dtype=torch.int32, device="cuda")

    def calls(d):
        q = randn(1, 4, 64, d).requires_grad_()
        k = randn(1, 2, 64, d)
        lse = torch.zeros(1, 4, 64, device="cuda")
        return (
            ("B13a / B13b", lambda: flash_bwd.flash_attention_bwd(
                q.detach(), k, k, q.detach(), q.detach(), lse, sm_scale=1.0, causal=True),
             (0, 0, 1, 1, 0)),
            ("the autograd op", lambda: ops["autodiff"].flash_attention(
                q, k, k, sm_scale=1.0, causal=True).sum().backward(), (1, 0, 1, 1, 0)),
            ("B12", lambda: flash_varlen.flash_attention_varlen(
                q[0].detach().transpose(0, 1), k[0].transpose(0, 1), k[0].transpose(0, 1),
                one, sm_scale=1.0, causal=True), (0, 0, 0, 0, 1)))

    for what, call, want in calls(100):
        before = [x.launches for x in counted]
        call()
        torch.cuda.synchronize()
        got = tuple(x.launches - n for x, n in zip(counted, before))
        print(f"  {what} at D 100: launches (P, B2, B13a, B13b, B12) {got}")
        check(got == want, f"{what} at D 100 (refused before the pitched rows) launches "
              f"{want}")
    head_dims_refused(torch, ops, "B13a / B13b, the autograd op and B12 (wide layouts up to 512)",
                      [lambda d, i=i: calls(d)[i][1]() for i in range(3)], counted,
                      dims=(520, 0))


PHI3_TRAIN_PATH = f"{PHI3_LABEL} training"
PHI3_TRAIN_S = 2040  # below Phi-3-mini's window of 2047, which the config leaves out


def phase_phi3_training(torch, ops, layers, kernels, path_counts, errs):
    """Phase 4o: `phase_training` at Phi-3-mini's widths, depth cut to
    TRAIN_LAYERS (or --layers), B TRAIN_B x S PHI3_TRAIN_S: P, B13a and
    B13b at D 96 in D 128's layout, each once a layer and step, on path
    PHI3_TRAIN_PATH. Then the cu_seqlens entry point at D 96 (32 / 32
    heads) over `varlen_batch`'s 32 sequences, causal (B12 once, path
    "phi3-widths varlen"), held to its plain version within BF16_TOL."""
    from flash_attention_cute_tpu_torch import flash_attention_varlen

    cfg = phi3_mini_widths_config(min(TRAIN_LAYERS, layers or TRAIN_LAYERS))
    print(f"  depth cut {phi3_mini_widths_config().num_layers} -> {cfg.num_layers} layers "
          f"(widths unchanged); sliding_window {PHI3_WINDOW} left out of the config: a "
          f"sequence of {PHI3_TRAIN_S} keys, where a window of {PHI3_WINDOW} masks nothing")
    check(PHI3_TRAIN_S < PHI3_WINDOW, "phase 4o's sequences stay below the window")
    out = phase_training(torch, cfg, kernels, path_counts, TRAIN_B, PHI3_TRAIN_S,
                         PHI3_TRAIN_PATH, seed=12)

    lens, _ = varlen_batch()
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, cu, _ = varlen_inputs(torch, torch.Generator(device="cuda").manual_seed(7373),
                                   lens, lens, hq, hkv, d)
    got, wall, counts = counted_run(torch, kernels,
                                    lambda: flash_attention_varlen(q, k, v, cu, causal=True))
    path_counts[f"{PHI3_LABEL} varlen"] = counts
    check_counts(counts, {"flash_varlen": 1}, f"{PHI3_LABEL} varlen")
    e = max_err(got, varlen_plain(torch, ops["flash_varlen"], q, k, v, cu, cu, causal=True))
    note_err(errs, "flash_varlen", e, "phi3")
    print(f"  flash_attention_varlen at D {d} ({hq} / {hkv} heads) over {len(lens)} sequences "
          f"({q.shape[0]} tokens): {wall * 1e3:.2f} ms (host clock), B12 1 launch, max|diff| "
          f"{e:.3e} against the plain version")
    check(tuple(got.shape) == tuple(q.shape) and bool(torch.isfinite(got).all()),
          "phi3 varlen output finite, [T, Hq, D]")
    check(e <= BF16_TOL, f"phi3 varlen within {BF16_TOL} of the plain version")
    out["varlen"] = {"sequences": len(lens), "tokens": q.shape[0], "wall_ms": wall * 1e3,
                     "max_abs_err": e}
    del q, k, v, got
    torch.cuda.empty_cache()
    return out


def phi3_training_rows(torch, ops, gen):
    """Phase 5h: the "phi3" entries of the B13a / B13b rows at phase 4o's
    attention (B 2, S 2040, 32 / 32 heads, D 96, causal; `bwd_timings`:
    library_ms SDPA's backward at D 96, fwd + bwd - fwd) and of the B12 row
    at its packed batch (`varlen_row`: SDPA over the padded batch). Bounds
    at D 96: the kernels run D 128's layout, so a quarter of their tile
    columns and products is padding, which counts against them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cfg = phi3_mini_widths_config()
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    out = bwd_timings(torch, ops, randn, TRAIN_B, hq, hkv, PHI3_TRAIN_S, d)
    for entry in out.values():
        library = entry.pop("library")
        entry["shape"] = (f"B {TRAIN_B}, S {PHI3_TRAIN_S}, causal, Hq {hq}, Hkv {hkv}, D {d} "
                          f"(phase 4o's step); plain_ms: the whole plain backward; library_ms: "
                          f"{library} at D {d}")
    out["flash_varlen"] = varlen_row(torch, ops["flash_varlen"], gen, hq, hkv, d)
    for entry in out.values():
        entry["padding"] = ("bound at D 96; the kernel runs in D 128's layout, a quarter of its "
                            "tile columns zeros")
    return out


# Phase 3m: GQA groups above 32 in the decodes D1, B5, B7 and B8, which cut
# such a group into chunks of at most 32 q rows, a block each
# (`dispatch.decode_group_chunks`), and above 8 in the paged extends B6 /
# B9, a block of which runs one q head. Decodes (name, head dim, q heads,
# kv heads, capacity, window, soft cap, q's dtype): groups of 33, 48
# (StarCoder's 48 / 1 heads), 64, 71 (Falcon-7B's 71 / 1; and over two kv
# heads) and 128 (128 / 1), at D 64, 96, 128 and 256, windows of 100 and
# 45, the caps 50 and 1.0, f16. Extends (name, page_size, head dim, q
# heads, kv heads, S, q_offset of rows 0-2, window, soft cap, q's dtype):
# Mistral-Large-2's group of 12 (96 / 8), Llama-3.1-405B's 16 (128 / 8)
# and Falcon-7B's 71 (71 / 1, D 64).
LARGE_GROUP_DECODES = (
    ("group 33 (66 / 2 heads), D 128, window 100", 128, 66, 2, 1030, 100, None, "bfloat16"),
    ("StarCoder's 48 / 1 heads, D 128", 128, 48, 1, 2051, None, None, "bfloat16"),
    ("group 64 (64 / 1 heads), D 256, cap 50", 256, 64, 1, 770, None, 50.0, "bfloat16"),
    ("Falcon-7B's 71 / 1 heads, D 64", 64, 71, 1, 2051, None, None, "bfloat16"),
    ("group 71 (142 / 2 heads), D 64, window 45, f16", 64, 142, 2, 1031, 45, None, "float16"),
    ("group 128 (128 / 1 heads), D 96, cap 1.0", 96, 128, 1, 577, None, 1.0, "bfloat16"),
)
M71_CASE = "Falcon-7B's 71 / 1 heads, D 64"  # its errors also go to "<kernel> m71"
LARGE_GROUP_EXTENDS = (
    ("Mistral-Large-2's group 12 (96 / 8 heads), S 256, page_size 16", 16, 128, 96, 8, 256,
     [0, 256, 1000], None, None, "bfloat16"),
    ("Llama-3.1-405B's group 16 (128 / 8 heads), S 130, page_size 128, window 45", 128, 128,
     128, 8, 130, [0, 61, 999], 45, None, "bfloat16"),
    ("Falcon-7B's group 71 (71 / 1 heads), D 64, S 65, page_size 16, cap 50, f16", 16, 64, 71,
     1, 65, [5, 300, 77], None, 50.0, "float16"),
)
MQA71_LABEL = "mqa-71"  # the launch-count path of the API call at Falcon-7B's heads


def phase_large_groups(torch, ops, errs):
    """Phase 3m: D1 + D2 and B7 + D2 (int8, e4m3) over each
    LARGE_GROUP_DECODES case's stacked cache (`held_contiguous_decodes`:
    lengths 0, 1, 37, C - 1, C, C / 2 + 3, NaN tails), B5 + D2 and B8 + D2
    (int8, e4m3) over NaN-poisoned pools of page_size 16 or 128 (lengths 0,
    1, a page edge either side, the whole table, 777), B6 and B9 (int8,
    e4m3) over each LARGE_GROUP_EXTENDS case (an inactive row), each against
    its fp32 plain version (3e-2), every call repeated bit for bit,
    length-0 and inactive rows exact zeros; D1's partials at Falcon-7B's
    heads at 7 splits (splits of no key among them) against the plain
    partials (1e-2). Falcon-7B's errors also go to "<kernel> m71",
    Llama-3.1-405B's group of 16 to "<kernel> g16"."""
    from flash_attention_cute_tpu_torch import dispatch

    flash_decode, pa, quantized = ops["flash_decode"], ops["paged_attention"], ops["quantized"]
    gen = torch.Generator(device="cuda").manual_seed(4392)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def held(what, key, tag, fn, plain, *args, **kw):
        return held_call(torch, errs, what, key, tag, fn, plain, *args, **kw)

    for i, (case, d, hq, hkv, cap_len, w, cap, dt) in enumerate(LARGE_GROUP_DECODES):
        dtype = getattr(torch, dt)
        tag = "m71" if case == M71_CASE else None
        chunks, rows = dispatch.decode_group_chunks(hq // hkv)
        name = f"{case} ({chunks} chunks of <= {rows} q rows)"
        held_contiguous_decodes(torch, flash_decode, quantized, errs, gen, (
            (f"{name}, capacity {cap_len}", d, hq, hkv, cap_len, w, cap, dt),),
            (None,) + QUANT_DTYPES, tag)
        ps, full = (16, 128)[i % 2], 1024
        lens = [0, 1, ps - 1, ps, ps + 1, full, 777, 2 * ps + 1]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qd = randn(len(lens), hq, 1, d, dtype=dtype)
        kp, vp, table = paged_pool(torch, lambda *sh: randn(*sh, dtype=dtype), gen, ps,
                                   rows=len(lens), capacity=full, layers=1, d=d, hkv=hkv)
        poison_past(torch, kp, table, lengths)
        poison_past(torch, vp, table, lengths)
        out = held(f"B5 + D2 {name}, page_size {ps}", "paged_decode", tag,
                   pa.paged_attention_decode, pa.paged_attention_decode_plain, qd, kp[0], vp[0],
                   lengths, table, window=w, logit_softcap=cap)
        check(bool((out[0] == 0).all()), f"B5 {name}: row of length 0 is exactly 0")
        del kp, vp
        for vname in QUANT_DTYPES:
            k, v, table = quant_pool(torch, quantized, randn, gen, ps, len(lens),
                                     getattr(torch, vname), lens, capacity=full, d=d, hkv=hkv)
            out = held(f"B8 + D2 {name}, {vname} page_size {ps}", "quant_paged_decode", tag,
                       quantized.paged_attention_decode_quantized,
                       quantized.paged_attention_decode_quantized_plain, qd, k, v, lengths,
                       table, window=w, logit_softcap=cap)
            check(bool((out[0] == 0).all()), f"B8 {name} {vname}: row of length 0 is exactly 0")
            del k, v
        if tag:  # D1's partials: chunk rows written at their offsets, dead splits too
            kc, vc = (randn(4, hkv, 577, d, dtype=dtype) for _ in "kv")
            q4 = qd[:4]
            lengths = torch.tensor([577, 300, 37, 0], dtype=torch.int32, device="cuda")
            got = flash_decode.decode_partials(q4, kc, vc, lengths, d ** -0.5, 7)
            want = flash_decode.decode_partials_plain(q4, kc, vc, lengths, d ** -0.5, 7)
            e = max(max_err(x, y) for x, y in zip(got, want))
            note_err(errs, "decode_partials", e, tag)
            print(f"  D1 partials {name}, 7 splits, lengths [577, 300, 37, 0]: max|diff| {e:.3e}")
            check(e <= 1e-2, f"D1 partials {name} within 1e-2")
            del kc, vc
        torch.cuda.empty_cache()

    for case, ps, d, hq, hkv, s, offs, w, cap, dt in LARGE_GROUP_EXTENDS:
        dtype = getattr(torch, dt)
        tag = "g16" if hq // hkv == 16 else ("m71" if hq // hkv == 71 else None)
        off = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
        kvl = torch.tensor([o + s for o in offs] + [0], dtype=torch.int32, device="cuda")
        kp, vp, table = paged_pool(torch, lambda *sh: randn(*sh, dtype=dtype), gen, ps, rows=4,
                                   capacity=2048, layers=1, d=d, hkv=hkv)
        poison_past(torch, kp, table, kvl)
        poison_past(torch, vp, table, kvl)
        qe = randn(4, s, hq, d, dtype=dtype).transpose(1, 2)  # the model's views
        out = held(f"B6 {case}, q_offset {offs}", "paged_extend", tag, pa.paged_attention_extend,
                   pa.paged_attention_extend_plain, qe, kp[0], vp[0], off, kvl, table, window=w,
                   logit_softcap=cap)
        check(bool((out[3] == 0).all()), f"B6 {case}: inactive row is exactly 0")
        del kp, vp
        for vname in QUANT_DTYPES:
            k, v, table = quant_pool(torch, quantized, randn, gen, ps, 4, getattr(torch, vname),
                                     kvl.tolist(), capacity=2048, d=d, hkv=hkv)
            out = held(f"B9 {case}, {vname}, q_offset {offs}", "quant_paged_extend", tag,
                       quantized.paged_attention_extend_quantized,
                       quantized.paged_attention_extend_quantized_plain, qe, k, v, off, kvl,
                       table, window=w, logit_softcap=cap)
            check(bool((out[3] == 0).all()), f"B9 {case} {vname}: inactive row is exactly 0")
            del k, v
        torch.cuda.empty_cache()


def phase_mqa71_path(torch, api, flash_decode, kernels, counts):
    """`api.flash_attention_forward` at Sq 1 on Falcon-7B's 71 q / 1 kv
    heads (D 64): B 8 over a cache of 2048 keys, lengths 2048, 1, 0, 777,
    2047, 1024, 64 and 1500, NaN past each; counted on path "mqa-71": D1
    once and D2 once, nothing else; held to the plain decode (3e-2), the
    length-0 row exactly 0."""
    gen = torch.Generator(device="cuda").manual_seed(4393)
    b, hq, cap_len, d = 8, 71, 2048, 64
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, 1, cap_len, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in "kv")
    lens = [2048, 1, 0, 777, 2047, 1024, 64, 1500]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(cap_len, device="cuda")[None, :] >= lengths[:, None]
    for x in (k, v):
        x[dead[:, None, :].expand(-1, 1, -1)] = float("nan")
    out, wall, launched = counted_run(torch, kernels, lambda: api.flash_attention_forward(
        q, k, v, kv_length=lengths))
    counts.update(launched)
    print(f"  api.flash_attention_forward at Sq 1, Falcon-7B's 71 / 1 heads, D {d}, B {b}, "
          f"cache {cap_len}, lengths {lens}: {wall * 1e3:.2f} ms (host clock), launches "
          f"{ {n: c for n, c in counts.items() if c} }")
    check_launched(counts, {"decode_partials": 1, "decode_combine": 1}, "the API at 71 / 1 heads")
    e = max_err(out, flash_decode.flash_attention_decode_plain(q.float(), k, v, lengths))
    print(f"  API decode at 71 / 1 heads: max|diff| {e:.3e} against the plain decode")
    check(bool(torch.isfinite(out).all()) and bool((out[2] == 0).all()),
          "API decode at 71 / 1 heads: finite over NaN tails, the length-0 row exactly 0")
    check(e <= BF16_TOL, f"API decode at 71 / 1 heads within {BF16_TOL}")


LLAMA405_LABEL = "405b-widths"  # the launch-count path of phase 4p
LLAMA405_LAYERS = 4  # of Llama-3.1-405B's 126 (see llama31_405b_widths_config)
LLAMA405_SERVING_RUNS = {name: SERVING_RUNS[name] for name in (
    "A whole-prompt", "B chunked", "D int8 whole-prompt", "E e4m3 chunked")}
# The kernels that must launch on phase 4p's paths: the group of 16 in the
# prefill, every decode and both paged extends.
LLAMA405_KERNELS = ("flash_fwd", "decode_partials", "decode_combine", "quant_append",
                    "quant_decode", "paged_decode", "paged_extend", "paged_append",
                    "quant_paged_decode", "quant_paged_extend")


def llama31_405b_widths_config(layers=0):
    """A Llama-family config at the widths of meta-llama/Llama-3.1-405B (its
    config.json): hidden 16384, 128 q / 8 kv heads (a GQA group of 16),
    head dim 128, SwiGLU 53248, vocab 128256, RMSNorm eps 1e-5, untied
    embeddings, RoPE theta 500000 with llama3 scaling (factor 8, low /
    high frequency factors 1 / 4, 8192 original positions), 131072
    positions. Depth is cut from 126 layers to `layers` (default
    LLAMA405_LAYERS): a layer holds 3.19 B parameters (6.38 GB in bf16) and
    the embeddings and the untied head 4.2 B (8.4 GB), so 4 layers take
    about 34 GB of the card's 80."""
    import torch
    from flash_attention_cute_tpu_torch.models.config import ModelConfig, RopeScaling

    return ModelConfig(vocab_size=128256, hidden_size=16384, intermediate_size=53248,
                       num_layers=layers or LLAMA405_LAYERS, num_q_heads=128, num_kv_heads=8,
                       head_dim=128, max_position_embeddings=131072, rms_norm_eps=1e-5,
                       rope_theta=500000.0,
                       rope_scaling=RopeScaling(rope_type="llama3", factor=8.0,
                                                low_freq_factor=1.0, high_freq_factor=4.0,
                                                original_max_position_embeddings=8192),
                       tie_word_embeddings=False, dtype=torch.bfloat16)


def phase_405b(torch, cfg, params, kernels, path_counts):
    """Phase 4p, at Llama-3.1-405B's widths (128 / 8 heads, group 16; depth
    cut, printed), on paths "405b-widths ...", each run's launch counts
    exact: teacher-forced prefill and decode-step logits of the kernel route
    against the plain route, greedy generation (B 4, prompt 512, 64 new: P,
    then D1 + D2) over a bf16 cache, the decode step and greedy over an int8
    cache (`quantized_greedy`: QA, B7 + D2), then the serving engine over
    `serving_requests` in runs A (whole-prompt, page_size 128: P, B5 + D2,
    the append), B (chunked 256, page_size 16: B6), D (A over int8 pages:
    QA, B8 + D2) and E (B over e4m3 pages: B9), every token teacher-forced;
    every kernel of LLAMA405_KERNELS launched on these paths."""
    import dataclasses

    full = llama31_405b_widths_config()
    per_layer = sum(t.numel() for t in params["layers"].values()) / cfg.num_layers
    print(f"  depth cut: 126 -> {cfg.num_layers} layers (widths unchanged: {full.num_q_heads} / "
          f"{full.num_kv_heads} heads, {per_layer / 1e9:.3f} B parameters a layer); "
          f"rope_scaling {dataclasses.asdict(cfg.rope_scaling)}")
    before = set(path_counts)
    ids, _, results = phase_family(torch, cfg, params, 11, B, PROMPT, NEW, kernels, path_counts,
                                   LLAMA405_LABEL)
    results.update(quantized_greedy(torch, cfg, params, ids, NEW, kernels, path_counts,
                                    LLAMA405_LABEL, ("int8",)))
    results.update(serve_long_requests(torch, cfg, params, kernels, path_counts, LLAMA405_LABEL,
                                       LLAMA405_SERVING_RUNS, serving_requests(cfg)))
    counts: dict = {}
    for path in set(path_counts) - before:
        check(path.startswith(LLAMA405_LABEL), f"phase 4p's path {path} is labelled "
              f"{LLAMA405_LABEL}")
        add_counts(counts, path_counts[path])
    for name in LLAMA405_KERNELS:
        check(counts.get(name, 0) > 0, f"{name} launched on path {LLAMA405_LABEL}")
    print(f"  {LLAMA405_LABEL}: prefill B{B} x {PROMPT} {results['prefill_ms']:.2f} ms, decode "
          f"{results['decode_ms_per_token']:.2f} ms/token; serving "
          + " / ".join(f"{r.split()[0]} {results[r]['wall_s']:.3f} s "
                       f"{results[r]['generated_tokens_per_s']:.1f} tokens/s"
                       for r in LLAMA405_SERVING_RUNS) + "; launches "
          + ", ".join(f"{k} {counts[k]}" for k in sorted(counts) if counts[k]))
    return results


def widths_rows(torch, ops, gen, cfg, chunked):
    """The entries of a model's widths (`cfg`) in the kernel rows: P, D1,
    D2 (`dense_rows`), B5, B6, the append (`paged_rows`), B7, B8, B9, QA
    (`quant_rows`) and, with `chunked`, B4 (`chunked_rows`), each with its
    bound; name -> entry."""
    def randn(*shape):  # at the port's row pitch, as the model's tensors lie
        return pitched(torch, torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))

    rows = dense_rows(torch, cfg, randn, ops["flash_fwd"], ops["flash_decode"])[0]
    rows += paged_rows(torch, cfg, randn, gen)
    rows += quant_rows(torch, cfg, randn, gen)
    if chunked:
        rows += chunked_rows(torch, cfg, gen)
    out = {}
    for r in rows:
        r.update(bound(r.pop("ops"), r.pop("bytes"), r.pop("peak")))
        out[r["name"]] = {k: v for k, v in r.items()
                          if k not in ("name", "route", "source", "replaces")}
    return out


def llama405_rows(torch, ops, gen):
    """Phase 5i: the "g16" entries of the P, D1, D2, B5, B6, append, B7,
    B8, B9 and QA rows at phase 4p's shapes (Llama-3.1-405B's 128 / 8
    heads, D 128): P at the greedy prefill (B 4, S 512), D1 / D2 / B7 at its
    middle decode step, B5 / B8 / the append / QA at run A's / D's decode,
    B6 / B9 at run B's / E's extend (`widths_rows`). library_ms: SDPA with
    the group expanded, over a contiguous copy where the kernel reads
    pages, dequantized where it reads int8 / e4m3 values."""
    out = widths_rows(torch, ops, gen, llama31_405b_widths_config(), chunked=False)
    for entry in out.values():
        entry.setdefault("shape", "phase 4p's")
    return out


def mqa71_rows(torch, ops, gen):
    """Phase 5i: the "m71" entries of the D1, B5, B7 and B8 rows at
    Falcon-7B's 71 / 1 heads, D 64, a decode of B 8 over 2048 keys a row
    (every key live): D1 (its partials alone, "with_combine_ms" D1 + D2)
    over a contiguous bf16 cache, B5 + D2 over bf16 pages of 16, B7 + D2
    over an int8 cache, B8 + D2 over int8 pages of 16. Each bound counts
    the visible K / V read once (B7 / B8: one-byte values and f32 scales),
    q read and the output written, at 3.35 TB/s, or 4 D operations a key
    and q head at the bf16 peak; library_ms one SDPA call over the cache
    with the group expanded (dequantized for B7 / B8; the copy not
    timed)."""
    from flash_attention_cute_tpu_torch import dispatch
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    fd, pa, qz = ops["flash_decode"], ops["paged_attention"], ops["quantized"]
    b, hq, hkv, cap_len, d, ps = 8, 71, 1, 2048, 64, 16
    chunks, rows_ = dispatch.decode_group_chunks(hq // hkv)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(b, hq, 1, d)
    lengths = torch.full((b,), cap_len, dtype=torch.int32, device="cuda")
    live = b * cap_len
    io = 2 * 2 * q.numel() + 4 * b
    ops_ = 4 * hq * live * d
    splits = dispatch.decode_num_splits(b, hkv, cap_len, d, hq // hkv)
    plan = (f"B {b}, Hq {hq}, Hkv {hkv}, D {d}, every row {cap_len} keys, {chunks} chunks of "
            f"<= {rows_} q rows, {splits} splits")
    out = {}

    def entry(fn, plain, library, nbytes, shape, **extra):
        return {"ms": cuda_time_ms(fn, 50), "call_ms": call_time_ms(fn, 50),
                "plain_ms": cuda_time_ms(plain, 10), "library_ms": cuda_time_ms(library, 50),
                **bound(ops_, nbytes, PEAK_BF16), "shape": shape, **extra}

    kc, vc = randn(b, hkv, cap_len, d), randn(b, hkv, cap_len, d)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kc, vc))
    scale = d ** -0.5
    out["decode_partials"] = entry(
        lambda: fd.decode_partials(q, kc, vc, lengths, scale, splits),
        lambda: fd.decode_partials_plain(q, kc, vc, lengths, scale, splits),
        lambda: f.scaled_dot_product_attention(q, kr, vr), io + 2 * 2 * hkv * live * d,
        f"{plan}; contiguous bf16 cache; ms D1 alone", library_of=LIBRARY_OF_D1,
        with_combine_ms=cuda_time_ms(lambda: fd.flash_attention_decode(q, kc, vc, lengths), 50))
    del kr, vr

    cache = [qz.quantize_kv(x, torch.int8) for x in (kc, vc)]
    kr, vr = (qz.dequantize_kv(x, torch.bfloat16).repeat_interleave(hq // hkv, dim=1)
              for x in cache)
    out["quant_decode"] = entry(
        lambda: qz.flash_attention_decode_quantized(q, *cache, lengths),
        lambda: qz.flash_attention_decode_quantized_plain(q, *cache, lengths),
        lambda: f.scaled_dot_product_attention(q, kr, vr), io + 2 * hkv * live * (d + 4),
        f"{plan}; contiguous int8 cache; ms includes D2")
    del kc, vc, kr, vr, cache

    kp, vp, table = paged_pool(torch, randn, gen, ps, rows=b, capacity=cap_len, layers=1, d=d,
                               hkv=hkv)
    kp, vp = kp[0], vp[0]
    pages = 4 * b * (cap_len // ps)  # the page-table entries read
    kr, vr = (pa.gather_pages(x, table).repeat_interleave(hq // hkv, dim=1) for x in (kp, vp))
    out["paged_decode"] = entry(
        lambda: pa.paged_attention_decode(q, kp, vp, lengths, table),
        lambda: pa.paged_attention_decode_plain(q, kp, vp, lengths, table),
        lambda: f.scaled_dot_product_attention(q, kr, vr), io + pages + 2 * 2 * hkv * live * d,
        f"{plan}; bf16 pages of {ps}; ms includes D2")
    del kr, vr
    pool = [qz.quantize_kv(x, torch.int8) for x in (kp, vp)]
    kr, vr = (qz._gather_dequantized(x, table).bfloat16().repeat_interleave(hq // hkv, dim=1)
              for x in pool)
    out["quant_paged_decode"] = entry(
        lambda: qz.paged_attention_decode_quantized(q, *pool, lengths, table),
        lambda: qz.paged_attention_decode_quantized_plain(q, *pool, lengths, table),
        lambda: f.scaled_dot_product_attention(q, kr, vr),
        io + pages + 2 * hkv * live * (d + 4), f"{plan}; int8 pages of {ps}; ms includes D2")
    del kp, vp, kr, vr, pool
    torch.cuda.empty_cache()
    return out


# Phases 3n / 4q / 5j: B4's (o, m, l) partials and sequence-parallel
# attention (parallel/sequence.py) at Llama-3.1-8B's attention widths
# (32 / 8 heads, D 128, bf16, B 1): a global sequence of 32768 tokens, a
# quarter of Llama-3.1's 131072-token context, over 8 ranks of 4096, the
# ring unrolled in one process; the fp32 plain dense reference at S 4096
# over 4 ranks; the public entry points over a one-rank NCCL mesh.
SP_LABEL = "sp"  # the launch-count path of phase 4q's unrolled ring and all-gather
SP_NCCL_LABEL = "sp nccl"  # the entry points over the one-rank NCCL mesh
SP_HEADS, SP_D, SP_S, SP_RANKS = (32, 8), 128, 32768, 8
SP_CHECK_S, SP_CHECK_RANKS = 4096, 4


class SpShape(NamedTuple):
    """A sequence-parallel phase (`phase_sequence_parallel`): (hq, hkv)
    heads and the head dim; the ring over `ranks` ranks at `s` tokens; the
    fp32 plain reference at `check_s` over `check_ranks` (its all-gather
    with the window `check_window`; `step` q heads at a time, 0: a kv head's
    group); the one-rank NCCL mesh at `nccl_s`; the all-gather's window
    (None: causal, then also held to the ring); the launch-count paths
    (and tags of the errors); the inputs' seed."""
    heads: tuple
    d: int
    s: int
    ranks: int
    check_s: int
    check_ranks: int
    nccl_s: int
    window: int | None
    check_window: int
    step: int
    label: str
    nccl_label: str
    seed: int


SP = SpShape(SP_HEADS, SP_D, SP_S, SP_RANKS, SP_CHECK_S, SP_CHECK_RANKS, SP_CHECK_S, None, 1000,
             0, SP_LABEL, SP_NCCL_LABEL, 4040)

# Phase 3n: B4's partials at ring attention's step geometries (name, dtype,
# (hq, hkv), S, capacity, q_offset per row, kv_length per row or None for
# the capacity, D, causal, window, cap): the offsets S_local, 0 and
# -S_local of one ring step (every key seen, the own chunk, a later chunk:
# an empty walk), the zig-zag's half shapes at S_local 4096 (the diagonal
# stripe, the high stripe against the pair at S_local / 2 and at S_local,
# both stripes against the low one), D 96 at Phi-3-mini's 32 / 32 heads,
# D 256 with the cap 50 at Gemma-2-9B's 16 / 8, the group of 16 at
# Llama-3.1-405B's 128 / 8 (S 5: sixteen heads a block; S 256: one), the
# window of 4096 with the cap 30 and NaN tails, a row of kv_length 0, a
# verify-sized chunk in f16 (two-part P), non-causal at D 64.
PARTIALS_CASES = (
    ("ring step offsets S / 0 / -S", "bfloat16", (32, 8), 2048, 2048, [2048, 0, -2048], None,
     128, True, None, None),
    ("zig-zag diagonal stripe", "bfloat16", (32, 8), 2048, 2048, [0], None, 128, True, None,
     None),
    ("zig-zag own pair, high stripe", "bfloat16", (32, 8), 2048, 4096, [2048], None, 128, True,
     None, None),
    ("zig-zag later pair, high stripe", "bfloat16", (32, 8), 2048, 4096, [4096], None, 128,
     True, None, None),
    ("zig-zag earlier pair, both stripes", "bfloat16", (32, 8), 4096, 2048, [4096], None, 128,
     True, None, None),
    ("D 96 (32 / 32)", "bfloat16", (32, 32), 1024, 1024, [1024, 0, -1024], None, 96, True, None,
     None),
    ("D 256 cap 50 (16 / 8)", "bfloat16", (16, 8), 1024, 1024, [1024, 0, -1024], None, 256,
     True, None, 50.0),
    ("group 16 S 5 (128 / 8)", "bfloat16", (128, 8), 5, 2048, [2048, 700, -5], None, 128, True,
     None, None),
    ("group 16 S 256 (128 / 8)", "bfloat16", (128, 8), 256, 1024, [1024, 300, -256], None, 128,
     True, None, None),
    ("window 4096 cap 30, NaN tails", "bfloat16", (32, 8), 512, 8192, [7000, 3000, 0],
     [7400, 3512, 300], 128, True, 4096, 30.0),
    ("kv_length 0 row", "bfloat16", (32, 8), 256, 1024, [1024, 100, 0], [1024, 356, 0], 128,
     True, None, None),
    ("f16 S 12 (two-part P), NaN tails", "float16", (32, 8), 12, 640, [640, 300, -12],
     [600, 312, 640], 128, True, None, None),
    ("non-causal D 64", "bfloat16", (8, 2), 300, 1000, [0, 0, 0], [1000, 400, 0], 64, False,
     None, None),
    # Head dims outside TMA's stride rule unpitched (rows of 104, 40 and 8).
    ("D 100 (32 / 8)", "bfloat16", (32, 8), 256, 1024, [1024, 0, -256], None, 100, True, None,
     None),
    ("D 36 (32 / 8)", "bfloat16", (32, 8), 256, 1024, [1024, 0, -256], None, 36, True, None,
     None),
    ("D 4 (32 / 8)", "bfloat16", (32, 8), 256, 1024, [1024, 0, -256], None, 4, True, None, None),
)


def partials_err(got, want) -> float:
    """B4's (o, m, l) partials against the plain ones: the largest of
    |o - o'| and |l - l'| over max(l', 1) (o and l grow with the visible
    keys; over l they are errors of the normalised output) and |m - m'|."""
    (o, m, l), (o_p, m_p, l_p) = got, want
    scale = l_p.clamp(min=1.0)
    return max(((o - o_p).abs() / scale[..., None]).max().item(),
               ((l - l_p).abs() / scale).max().item(), (m - m_p).abs().max().item())


def phase_partials_kernels(torch, flash_chunked, errs):
    """Phase 3n: B4's partials against the plain partials over
    PARTIALS_CASES, the model's transposed views, NaN at and past every
    kv_length: `partials_err` within BF16_TOL, rows with no visible key
    exact (m = l = o = 0), every value finite, a second call bit for bit.
    Errors go to errs["flash_chunked_partials"]."""
    gen = torch.Generator(device="cuda").manual_seed(5353)
    for name, dt, (hq, hkv), s, cap, offs, kvl, d, causal, w, sc in PARTIALS_CASES:
        kvl = kvl or [cap] * len(offs)
        q, k, v, off, lens = chunked_inputs(torch, gen, getattr(torch, dt), s, cap, offs, kvl, d,
                                            hq, hkv)
        kw = dict(causal=causal, window=w, logit_softcap=sc, return_partials=True)
        got = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
        again = flash_chunked.flash_attention_chunked(q, k, v, off, lens, **kw)
        want = flash_chunked.flash_attention_chunked_plain(q, k, v, off, lens, **kw)
        e = partials_err(got, want)
        note_err(errs, "flash_chunked_partials", e, O_TAGS.get(d))
        dead = want[2] == 0
        print(f"  B4-partials {name} (q_offset {offs}, kv_length {kvl}): error {e:.3e}, "
              f"{int(dead.sum())} rows with no key")
        check(e <= BF16_TOL, f"B4-partials {name} within {BF16_TOL}")
        check(all(bool(torch.isfinite(x).all()) for x in got), f"B4-partials {name} finite")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"B4-partials {name} repeats bit for bit")
        check(bool((got[1][dead] == 0).all()) and bool((got[2][dead] == 0).all())
              and bool((got[0][dead] == 0).all()),
              f"B4-partials {name}: rows with no key are m = l = o = 0")
        del q, k, v, got, again, want
    torch.cuda.empty_cache()


def held_rows(torch, errs, what, key, tag, got, ref, again=None, pitch=None) -> tuple:
    """A kernel's output, or its (o, m, l) partials, against `ref`: the
    same shape, finite, max |diff| (the partials: `partials_err`) within
    BF16_TOL and `row_err` (`partials_row_err`) within ROW_TOL, equal to
    `again` bit for bit where given, rows at the pitch `pitch` where given;
    noted under `key` and "<key> row_err" (and "<...> <tag>"). Returns the
    two errors."""
    parts = isinstance(got, tuple)
    e, r = ((partials_err(got, ref), partials_row_err(got, ref)) if parts
            else (max_err(got, ref), row_err(got, ref)))
    got_, ref_ = (got, ref) if parts else ((got,), (ref,))
    note_err(errs, key, e, tag)
    note_err(errs, f"{key} row_err", r, tag)
    same = again is None or all(torch.equal(a, b)
                                for a, b in zip(got_, again if parts else (again,)))
    print(f"  {what}: {'partials_err' if parts else 'max|diff|'} {e:.3e}, row_err {r:.3e}"
          + ("" if again is None else f", repeated bit for bit: {same}"))
    check(all(a.shape == b.shape for a, b in zip(got_, ref_)), f"{what}: the plain shape")
    check(all(bool(torch.isfinite(x).all()) for x in got_), f"{what}: finite")
    check(e <= BF16_TOL, f"{what} within {BF16_TOL}")
    check(r <= ROW_TOL, f"{what}: row_err within {ROW_TOL}")
    check(same, f"{what}: a second call repeats bit for bit")
    if pitch is not None:
        check(got_[0].stride(-2) == pitch, f"{what}: rows at the pitch {pitch}")
    return e, r


def sp_inputs(torch, gen, s, sp=SP):
    """q [1, hq, s, d], k / v [1, hkv, s, d] of `sp` in bf16 (unit normal),
    rows at the port's pitch."""
    def randn(*shape):
        return pitched(torch, torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))

    hq, hkv = sp.heads
    return randn(1, hq, s, sp.d), randn(1, hkv, s, sp.d), randn(1, hkv, s, sp.d)


def sp_partials_launches(n: int, s_local: int, causal: bool) -> int:
    """B4-partials launches of an n-rank ring: two at each rank's own pair
    on the zig-zag (causal, even S_local), one at every other step."""
    return n * (n + 1) if causal and s_local % 2 == 0 else n * n


def sp_reference_checks(torch, errs, gen, sp, numbers=None):
    """The unrolled ring over sp.check_ranks ranks at sp.check_s tokens,
    causal (zig-zag), non-causal and causal at S - ranks (an odd S_local:
    the three offsets), and the unrolled all-gather (causal, window
    sp.check_window) against the fp32 plain dense reference (`by_kv_head`,
    sp.step q heads at a time), by `held_rows` under sp.label."""
    from flash_attention_cute_tpu_torch.ops.reference import attention_reference
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    m = sp.check_ranks
    for what, s, causal, fn, kw in (
            ("ring causal (zig-zag)", sp.check_s, True, seq.ring_attention_unrolled, {}),
            ("ring non-causal", sp.check_s, False, seq.ring_attention_unrolled, {}),
            ("ring causal, odd S_local (three offsets)", sp.check_s - m, True,
             seq.ring_attention_unrolled, {}),
            (f"all-gather causal, window {sp.check_window}", sp.check_s, True,
             seq.allgather_attention_unrolled, {"window": sp.check_window})):
        q, k, v = sp_inputs(torch, gen, s, sp)
        got = fn(q, k, v, m, causal=causal, **kw)
        ref = by_kv_head(torch, lambda q_, k_, v_: attention_reference(
            q_.float(), k_.float(), v_.float(), causal=causal, window=kw.get("window")),
            q, k, v, sp.step)
        name = f"{what}, D {sp.d}, S {s} over {m} ranks, vs the fp32 plain reference"
        e, r = held_rows(torch, errs, name, "flash_chunked" if kw else "flash_chunked_partials",
                         sp.label, got, ref)
        if numbers is not None:
            numbers[f"{name} max_abs_err"], numbers[f"{name} row_err"] = e, r
        del q, k, v, got, ref
    torch.cuda.empty_cache()


def phase_sequence_parallel(torch, flash_fwd, kernels, path_counts, errs, sp=SP):
    """Phases 4q (SP) and 5m (V4X_SP): (a) path sp.label: the ring over
    sp.ranks ranks unrolled in one process (`ring_attention_unrolled`),
    causal (zig-zag) and non-causal, and the all-gather route
    (`allgather_attention_unrolled`, causal, the window sp.window) at sp.s
    tokens, counted: B4-partials n (n + 1) + n^2, B4 n, nothing else; (b)
    `sp_reference_checks`; (c) path sp.nccl_label: the public entry points
    `ring_attention` (causal, non-causal) and `allgather_attention` over a
    one-rank NCCL `DeviceMesh` on cuda:0 at sp.nccl_s. In (a) and (c) each
    output against P / B2 over the whole sequence (without a window the
    ring against the all-gather too) by `held_rows`. Returns the errors of
    every comparison."""
    import datetime
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from flash_attention_cute_tpu_torch.parallel import mesh as pmesh
    from flash_attention_cute_tpu_torch.parallel import sequence as seq

    numbers = {}
    gen = torch.Generator(device="cuda").manual_seed(sp.seed)
    n, s_local = sp.ranks, sp.s // sp.ranks
    gather = f"all-gather, window {sp.window}" if sp.window else "all-gather, causal"

    def held(what, got, want, key="flash_chunked_partials"):
        e, r = held_rows(torch, errs, what, key, sp.label, got, want)
        numbers[f"{what} max_abs_err"], numbers[f"{what} row_err"] = e, r
        return e

    def against_p(q, k, v, outs, where):
        ring_c, ring_n, gathered = outs
        p_c = flash_fwd.flash_attention_fwd(q, k, v, causal=True)
        held(f"ring causal (zig-zag), {where}, vs P", ring_c, p_c)
        if sp.window is None:
            held(f"{gather}, {where}, vs P", gathered, p_c, "flash_chunked")
            numbers[f"ring vs all-gather, {where}"] = held(
                f"ring vs all-gather, {where}", ring_c, gathered)
        del p_c, ring_c
        held(f"ring non-causal, {where}, vs P", ring_n,
             flash_fwd.flash_attention_fwd(q, k, v, causal=False))
        if sp.window:
            held(f"{gather}, {where}, vs B2", gathered,
                 flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=sp.window),
                 "flash_chunked")

    q, k, v = sp_inputs(torch, gen, sp.s, sp)
    outs, wall, counts = counted_run(torch, kernels, lambda: (
        seq.ring_attention_unrolled(q, k, v, n, causal=True),
        seq.ring_attention_unrolled(q, k, v, n, causal=False),
        seq.allgather_attention_unrolled(q, k, v, n, causal=True, window=sp.window)))
    want = {"flash_chunked_partials": sp_partials_launches(n, s_local, True)
            + sp_partials_launches(n, s_local, False), "flash_chunked": n}
    check_counts(counts, want, sp.label)
    add_counts(path_counts.setdefault(sp.label, {}), counts)
    print(f"  path {sp.label!r}: {n} ranks of {s_local} tokens, {wall:.3f} s; launches "
          f"B4-partials {counts['flash_chunked_partials']}, B4 {counts['flash_chunked']}")
    against_p(q, k, v, outs, f"{n} ranks over {sp.s}")
    del outs, q, k, v
    torch.cuda.empty_cache()

    sp_reference_checks(torch, errs, gen, sp, numbers)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pmesh.init_distributed(backend="nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                           rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("sp",))
        q, k, v = sp_inputs(torch, gen, sp.nccl_s, sp)
        outs, wall, counts = counted_run(torch, kernels, lambda: (
            seq.ring_attention(q, k, v, mesh, causal=True),
            seq.ring_attention(q, k, v, mesh, causal=False),
            seq.allgather_attention(q, k, v, mesh, causal=True, window=sp.window)))
        check_counts(counts, {"flash_chunked_partials": 3, "flash_chunked": 1}, sp.nccl_label)
        add_counts(path_counts.setdefault(sp.nccl_label, {}), counts)
        print(f"  path {sp.nccl_label!r}: one-rank {dist.get_backend()} mesh on "
              f"{torch.cuda.get_device_name(0)} at S {sp.nccl_s}, {wall:.3f} s; B4-partials "
              f"{counts['flash_chunked_partials']}, B4 {counts['flash_chunked']}")
        against_p(q, k, v, outs, "over NCCL")
        del outs, q, k, v
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return numbers


def sp_times(torch, flash_fwd, sp, gen) -> dict:
    """The unrolled ring over sp.ranks ranks at sp.s tokens, causal and
    non-causal, and the all-gather route (sp.window) beside P (and B2 at
    the window) over the whole sequence and one SDPA call (causal,
    `sdpa_entry`); the causal bound (4 d operations a visible pair and q
    head at the bf16 rate) and the ring's causal time over P's and SDPA's."""
    from flash_attention_cute_tpu_torch.parallel import sequence as seq
    from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms

    q, k, v = sp_inputs(torch, gen, sp.s, sp)
    n, w = sp.ranks, sp.window
    out = {
        "shape": f"B 1, {sp.heads[0]} / {sp.heads[1]} heads, D {sp.d}, S {sp.s} over {n} "
                 f"ranks of {sp.s // n}, unrolled on one card",
        "ring_causal_ms": cuda_time_ms(
            lambda: seq.ring_attention_unrolled(q, k, v, n, causal=True), 3, 1),
        "ring_noncausal_ms": cuda_time_ms(
            lambda: seq.ring_attention_unrolled(q, k, v, n, causal=False), 3, 1),
        f"allgather_{'window' if w else 'causal'}_ms": cuda_time_ms(
            lambda: seq.allgather_attention_unrolled(q, k, v, n, causal=True, window=w), 3, 1),
        "p_causal_ms": cuda_time_ms(lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True),
                                    3, 1),
        "causal_bound_ms": 1e3 * 4 * sp.heads[0] * sp.d * (sp.s * (sp.s + 1) // 2) / PEAK_BF16}
    if w:
        out["b2_window_ms"] = cuda_time_ms(
            lambda: flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=w), 3, 1)
    lib = sdpa_entry(torch, q, k, v, is_causal=True)
    out.update(sdpa_causal_ms=lib["library_ms"], sdpa=lib["library"],
               ring_causal_over_p=out["ring_causal_ms"] / out["p_causal_ms"])
    if out["sdpa_causal_ms"]:
        out["ring_causal_over_sdpa"] = out["ring_causal_ms"] / out["sdpa_causal_ms"]
    del q, k, v
    torch.cuda.empty_cache()
    return out


def sp_rows(torch, flash_chunked, flash_fwd):
    """Phase 5j: the row of B4's partials ("flash_chunked_partials", the
    ring's kernel) at a non-causal ring step of phase 4q's shape (4096 rows
    against a chunk of 4096 keys, q_offset 4096: every key visible) and,
    under "zigzag_step", at a zig-zag step (4096 rows against the low
    stripe of 2048 keys); bounds: 4 D operations a visible (row, key) pair
    and q head at the bf16 peak, or q, k, v read and o (fp32), m, l written
    once; library_ms null (no PyTorch call returns the partials). Under
    "sequence_parallel": `sp_times` over 8 ranks at 32768 tokens."""
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    gen = torch.Generator(device="cuda").manual_seed(86)
    hq, hkv = SP_HEADS
    s_local = SP_S // SP_RANKS

    def step(rows, keys, offset, iters):
        q, k, v = sp_inputs(torch, gen, rows)[0], *sp_inputs(torch, gen, keys)[1:]
        off = torch.full((1,), offset, dtype=torch.int32, device="cuda")
        kvl = torch.full((1,), keys, dtype=torch.int32, device="cuda")
        fn = lambda: flash_chunked.flash_attention_chunked(q, k, v, off, kvl,  # noqa: E731
                                                           return_partials=True)
        nbytes = 2 * q.numel() + 2 * 2 * k.numel() + 4 * q.numel() + 2 * 4 * hq * rows + 8
        return {"shape": f"B 1, {hq} / {hkv} heads, D {SP_D}, {rows} rows against {keys} "
                         f"keys, q_offset {offset} (every key visible)",
                "ms": cuda_time_ms(fn, iters), "call_ms": call_time_ms(fn, iters),
                "plain_ms": cuda_time_ms(lambda: flash_chunked.flash_attention_chunked_plain(
                    q, k, v, off, kvl, return_partials=True), 3, 1),
                "library_ms": None, **bound(4 * hq * SP_D * rows * keys, nbytes, PEAK_BF16)}

    row = step(s_local, s_local, s_local, 20)
    row["zigzag_step"] = step(s_local, s_local // 2, s_local, 20)
    row["sequence_parallel"] = sp_times(torch, flash_fwd, SP, gen)
    return [{"name": "flash_chunked_partials", "route": "cuda",
             "source": "flash_attention_cute_tpu_torch/csrc/flash_chunked.cu",
             "replaces": "flash_attention_cute_tpu/ops/flash_chunked.py:47",
             "library_of": "none: no single PyTorch call returns the (o, m, l) partials", **row}]


# Phases 3o / 4r / 5k: every head dim from 1 to 256. A head dim whose rows
# are no whole 16 bytes runs over rows at the port's pitch
# (`_build.row_pitch`): the port allocates its caches, pools and outputs so,
# and copies once a caller's tensor at another stride (`_build.rows`,
# counted in `_build.copies` by kind). (head dim, q heads, kv heads, q's
# dtype) at Llama-3-8B's 32 / 8 heads: two-byte rows of D 4, 36 and 100
# (pitches 8, 40, 104), one-byte rows of D 24, 40 and 72 (pitches 32, 48,
# 80 bytes), the backward and B12 at D 36 and 100; the int8 scores at D 4,
# 40, 96 (Phi-3-mini's 32 / 32 heads) and 100.
PITCHED_HEAD_DIMS = ((4, 32, 8, "bfloat16"), (36, 32, 8, "bfloat16"), (100, 32, 8, "bfloat16"))
PITCHED_ONE_BYTE_DIMS = ((24, 32, 8, "bfloat16"), (40, 32, 8, "bfloat16"),
                         (72, 32, 8, "bfloat16"))
PITCHED_TRAINING_DIMS = ((36, 32, 8, "bfloat16"), (100, 32, 8, "bfloat16"))
PITCHED_INT8_CASES = (
    ("Phi-3-mini B4 S512 D96", B, 32, 32, PROMPT, PROMPT, 96, True, None, None, "bfloat16",
     True),
    ("D100 B1 S1000 W100", 1, 32, 8, 1000, 1000, 100, True, 100, None, "bfloat16", True),
    ("D40 f16 S333 cap 30", 2, 32, 8, 333, 333, 40, True, None, 30.0, "float16", False),
    ("D4 non-causal Sq200 Skv700", 2, 32, 8, 200, 700, 4, False, None, None, "bfloat16", True),
    ("D100 B2 S333 causal", 2, 32, 8, 333, 333, 100, True, None, None, "bfloat16", False),
)
# The tags of errs under which the "O" entries' errors go: two-byte rows at
# D 100, one-byte rows at D 40.
O_TAGS, O_ONE_BYTE_TAGS = {100: "o100"}, {40: "o40"}
PITCHED_LABEL = "pitched"  # the launch-count paths of phase 4r: "pitched d100 ...", "... d40"
PHI3_INT8_LABEL = f"{PHI3_LABEL} int8 scores"  # phase 3o's int8-score path
PHI3_INT8_LONG = 4096  # phase 3o's windowed int8 prefill: 4096 keys, Phi-3-mini-4k's window binds


def phase_pitched_head_dims(torch, ops, paged_cache, errs, rel_errs):
    """Phase 3o: K8 (bit-identical) and P-i8 / B2-i8 at PITCHED_INT8_CASES;
    P / B2, D1 + D2, B5 + D2, B6 and the append at PITCHED_HEAD_DIMS (D 100
    also windowed and capped); B4 there too; B7 + D2, B8 + D2, B9, QA and
    B4 at PITCHED_ONE_BYTE_DIMS (D 40 also windowed and capped); B13a /
    B13b and B12 at PITCHED_TRAINING_DIMS: each against its fp32 plain
    version within the tolerances of phases 3i-3l, over NaN tails and
    poisoned pools at the port's row pitch and the model's transposed views
    (one padded copy each), every call repeated bit for bit. Then D 264 and
    D 0 refused by P-i8 (K8), D 520 and D 0 by P / B2, B6, D1, B5 and the
    append (which take 257-512 in the wide layouts, phases 5l-5n; B6, D1,
    B5 and the append launch once at D 264, B6 and the decodes held to
    their fp32 plain versions by `held_rows`), before any launch. Prints
    the padded copies the phase made."""
    from flash_attention_cute_tpu_torch.ops import _build

    flash_fwd, flash_decode, pa = ops["flash_fwd"], ops["flash_decode"], ops["paged_attention"]
    before = dict(_build.copies)
    phase_int8_kernels(torch, flash_fwd, errs, PITCHED_INT8_CASES, {96: "phi3", **O_TAGS})
    phase_odd_head_dims(torch, ops, paged_cache, errs, PITCHED_HEAD_DIMS, O_TAGS)
    phase_odd_head_dims_quantized(torch, ops, errs, PITCHED_HEAD_DIMS, O_TAGS, one_byte=False,
                                  formerly_refused=False)
    phase_odd_head_dims_quantized(torch, ops, errs, PITCHED_ONE_BYTE_DIMS, O_ONE_BYTE_TAGS,
                                  formerly_refused=False)
    phase_odd_head_dims_training(torch, ops, errs, rel_errs, PITCHED_TRAINING_DIMS, O_TAGS,
                                 formerly_refused=False)
    gen = torch.Generator(device="cuda").manual_seed(4393)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").view(2, 4)
    counted = (flash_fwd.PREFILL, flash_fwd.WINDOWED_PREFILL, flash_fwd.PREFILL_INT8,
               flash_fwd.QUANTIZE_K, flash_decode.PARTIALS, pa.PAGED_DECODE, pa.PAGED_EXTEND,
               paged_cache.APPEND)
    # B6 takes 257-512 in the wide layout (phase 5m): D 264 launches it once,
    # held to its fp32 plain version by `held_rows`.
    q264, kp264, vp264 = randn(2, 4, 5, 264), randn(2, 9, 16, 264), randn(2, 9, 16, 264)
    launched = pa.PAGED_EXTEND.launches
    out = pa.paged_attention_extend(q264, kp264, vp264, rows, rows + 5, table)
    torch.cuda.synchronize()
    launched = pa.PAGED_EXTEND.launches - launched
    print(f"  B6 at D 264 (the wide layout): launched {launched}")
    check(launched == 1, "B6 at D 264 launches its kernel once")
    held_rows(torch, errs, "B6 at D 264", "paged_extend", "wide", out,
              pa.paged_attention_extend_plain(q264.float(), kp264, vp264, rows, rows + 5, table))
    head_dims_refused(torch, ops, "P / B2 and B6 (wide layout up to 512)", [
        lambda d: flash_fwd.flash_attention_fwd(randn(2, 4, 64, d), randn(2, 2, 64, d),
                                                randn(2, 2, 64, d), sm_scale=1.0, causal=True),
        lambda d: flash_fwd.flash_attention_fwd(randn(2, 4, 64, d), randn(2, 2, 64, d),
                                                randn(2, 2, 64, d), sm_scale=1.0, window=8,
                                                causal=True),
        lambda d: pa.paged_attention_extend(randn(2, 4, 5, d), randn(2, 9, 16, d),
                                            randn(2, 9, 16, d), rows, rows + 5, table,
                                            sm_scale=1.0)], counted, dims=(520, 0))
    head_dims_refused(torch, ops, "P-i8 (K8)", [
        lambda d: flash_fwd.flash_attention_fwd(randn(2, 4, 64, d), randn(2, 2, 64, d),
                                                randn(2, 2, 64, d), sm_scale=1.0, causal=True,
                                                score_dtype="int8"),
        lambda d: flash_fwd.quantize_k_rows(randn(2, 2, 64, d))], counted)
    # D1, B5 and the append take 257-512 (the wide layout of the decodes,
    # phase 5n): D 264 launches each once (D1 and B5 with D2), the decodes
    # held to their fp32 plain versions by `held_rows`; D 520 and D 0 are
    # refused.
    q264, k264, v264 = randn(2, 4, 1, 264), randn(2, 2, 64, 264), randn(2, 2, 64, 264)
    kp264, vp264 = randn(2, 9, 16, 264), randn(2, 9, 16, 264)
    wide = (flash_decode.PARTIALS, pa.PAGED_DECODE, paged_cache.APPEND, flash_decode.COMBINE)
    wide_before = [x.launches for x in wide]
    got = (flash_decode.flash_attention_decode(q264, k264, v264, rows),
           pa.paged_attention_decode(q264, kp264, vp264, rows, table))
    paged_cache.paged_append_layer(kp264, vp264, k264[:, :, :1], v264[:, :, :1], table, rows)
    torch.cuda.synchronize()
    launched = [x.launches - n for x, n in zip(wide, wide_before)]
    print(f"  D1, B5, the append and D2 at D 264 (the wide layout): launched {launched}")
    check(launched == [1, 1, 1, 2], "D1, B5 and the append at D 264 launch their kernels once "
                                    "each, D2 after each decode")
    held_rows(torch, errs, "D1 + D2 at D 264", "decode_partials", "wide", got[0],
              flash_decode.flash_attention_decode_plain(q264.float(), k264, v264, rows))
    # (the append wrote at the lengths, which the decode does not read)
    held_rows(torch, errs, "B5 + D2 at D 264", "paged_decode", "wide", got[1],
              pa.paged_attention_decode_plain(q264.float(), kp264, vp264, rows, table))
    head_dims_refused(torch, ops, "D1, B5 and the append (wide layout up to 512)", [
        lambda d: flash_decode.flash_attention_decode(randn(2, 4, 1, d), randn(2, 2, 64, d),
                                                      randn(2, 2, 64, d), rows, sm_scale=1.0),
        lambda d: pa.paged_attention_decode(randn(2, 4, 1, d), randn(2, 9, 16, d),
                                            randn(2, 9, 16, d), rows, table, sm_scale=1.0),
        lambda d: paged_cache.paged_append_layer(randn(2, 9, 16, d), randn(2, 9, 16, d),
                                                 randn(2, 2, 1, d), randn(2, 2, 1, d), table,
                                                 rows)], counted, dims=(520, 0))
    print(f"  padded copies in phase 3o: "
          + ", ".join(f"{k} {_build.copies[k] - before[k]}" for k in before)
          + " (the transposed views of q / k / v and contiguous caches at D 4, 36 and 100)")


def phase_int8_phi3_path(torch, api, flash_fwd, kernels, counts, errs):
    """Phase 3o's path: the API's dense prefill with score_dtype="int8" at
    Phi-3-mini's widths (32 / 32 heads, D 96 in D 128's layout): causal at
    B 4 x 512, then Phi-3-mini-4k's window of 2047 at B 1 x 4096, where it
    binds; counted exactly: K8 twice, P-i8 once, B2-i8 once, nothing else.
    Each output against the plain int8 version (BF16_TOL) and the fp32
    oracle of bf16 scores (INT8_ORACLE_TOL)."""
    cfg = phi3_mini_widths_config()
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(4394)
    causal = int8_inputs(torch, gen, B, hq, hkv, PROMPT, PROMPT, d, "bfloat16", True)
    long = int8_inputs(torch, gen, 1, hq, hkv, PHI3_INT8_LONG, PHI3_INT8_LONG, d, "bfloat16",
                       True)
    outs, wall, launched = counted_run(torch, kernels, lambda: (
        api.flash_attention_forward(*causal, causal=True, score_dtype="int8"),
        api.flash_attention_forward(*long, causal=True, window=PHI3_WINDOW, score_dtype="int8")))
    counts.update(launched)
    print(f"  api.flash_attention_forward(score_dtype='int8') at Phi-3-mini's widths: B{B} "
          f"S{PROMPT} causal, B1 S{PHI3_INT8_LONG} W{PHI3_WINDOW}: {wall:.3f} s, launches "
          f"{ {n: c for n, c in counts.items() if c} }")
    check_launched(counts, {"quantize_k_rows": 2, "flash_fwd_int8": 1, "flash_fwd_window_int8": 1},
                   f"the int8-score API route at Phi-3-mini's widths ({PHI3_INT8_LABEL})")
    for (q, k, v), out, w in zip((causal, long), outs, (None, PHI3_WINDOW)):
        ref = by_kv_head(torch, lambda q_, k_, v_: flash_fwd.int8_attention_plain(
            q_, k_, v_, d ** -0.5, True, w, None, False, out_dtype=torch.float32), q, k, v)
        e = max_err(out, ref)
        del ref
        oracle = by_kv_head(torch, lambda q_, k_, v_: flash_fwd.flash_attention_fwd_plain(
            q_.float(), k_.float(), v_.float(), causal=True, window=w), q, k, v)
        e_oracle = max_err(out, oracle)
        del oracle
        note_err(errs, "flash_fwd_window_int8" if w else "flash_fwd_int8", e, "phi3")
        print(f"  {PHI3_INT8_LABEL} (window {w}): vs plain int8 {e:.3e}, vs fp32 oracle "
              f"{e_oracle:.3e}")
        check(bool(torch.isfinite(out).all()), f"{PHI3_INT8_LABEL} (window {w}) finite")
        check(e <= BF16_TOL, f"{PHI3_INT8_LABEL} (window {w}) within {BF16_TOL} of plain int8")
        check(e_oracle <= INT8_ORACLE_TOL,
              f"{PHI3_INT8_LABEL} (window {w}) within {INT8_ORACLE_TOL} of the fp32 oracle")
    del causal, long, outs
    torch.cuda.empty_cache()


def pitched_model_config(d, layers=0):
    """Llama-3-8B's widths (hidden 4096, 32 / 8 heads, SwiGLU 14336, vocab
    128256) at head dim `d`, cut to 2 layers (or `layers`): the shallow
    models of phase 4r. No public config has such a head dim (PERF.md
    section 4)."""
    import dataclasses
    from flash_attention_cute_tpu_torch.models.llama import llama3_8b_config

    return dataclasses.replace(llama3_8b_config(), head_dim=d, num_layers=layers or 2)


PITCHED_SERVING_REQUESTS = 8  # the first 8 of `serving_requests`: phase 4r stays short


def phase_pitched_models(torch, kernels, path_counts, layers):
    """Phase 4r: shallow models (`pitched_model_config`, 2 layers) at D 100
    over bf16 caches and pages (rows of 104) and at D 40 over int8 and e4m3
    pages (rows of 48 bytes). D 100: teacher-forced prefill and decode-step
    logits, kernel route against the plain route, and greedy generation (B 4,
    prompt 512, 64 new: P, D1 + D2) with exact launch counts (`phase_family`),
    then serving runs A (whole-prompt) and B (chunked) over 8 requests of
    `serving_requests` (P, B5 + D2, B6, the append), every token teacher-
    forced (`serve_long_requests`). D 40: greedy over int8 and e4m3 caches
    (`quantized_greedy`: QA, B7 + D2, the decode step against the plain
    route) and serving runs D (int8, whole-prompt) and E (e4m3, chunked: QA,
    B8 + D2, B9). No cache or pool is copied (`_build.copies["cache"]` 0 on
    every path); the activations' padded copies are printed."""
    import numpy as np

    from flash_attention_cute_tpu_torch.models.transformer import init_params
    from flash_attention_cute_tpu_torch.ops import _build

    results = {}
    for seed, d, runs in ((13, 100, PHI3_SERVING_RUNS), (14, 40, PHI3_QUANT_SERVING_RUNS)):
        cfg = pitched_model_config(d, layers)
        label = f"{PITCHED_LABEL} d{d}"
        params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
        before = dict(_build.copies)
        t0 = time.perf_counter()
        if d == 100:
            _, _, out = phase_family(torch, cfg, params, seed, B, PROMPT, NEW, kernels,
                                     path_counts, label)
        else:
            ids = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (B, PROMPT))).to("cuda")
            out = quantized_greedy(torch, cfg, params, ids, NEW, kernels, path_counts, label,
                                   QUANT_DTYPES)
        out.update(serve_long_requests(torch, cfg, params, kernels, path_counts, label, runs,
                                       serving_requests(cfg)[:PITCHED_SERVING_REQUESTS]))
        copies = {k: _build.copies[k] - before[k] for k in before}
        out["padded_copies"], out["phase_s"] = copies, time.perf_counter() - t0
        print(f"  {label} ({cfg.num_layers} layers, {cfg.num_q_heads} / {cfg.num_kv_heads} "
              f"heads, D {d}): padded copies {copies} in {out['phase_s']:.1f} s")
        check(copies["cache"] == 0, f"{label}: no cache or pool copied on any path")
        results[label] = out
        del params
        torch.cuda.empty_cache()
    return results


def pitched_rows(torch, ops, gen):
    """Phase 5k: the "o" entries of every kernel row with a head dim at D
    100 over two-byte rows (pitch 104) and, for the one-byte rows (B7, B8,
    B9, QA), at D 40 (pitch 48 bytes), at phase 4r's widths (32 / 8 heads)
    and shapes (`widths_rows`: P, D1, D2, B5, B6, the append, B4, B7, B8,
    B9, QA; `int8_entry`: P-i8, B2-i8 and K8; `bwd_timings`: B13a / B13b at
    B 2 x S 2048; `varlen_row`: B12; B4's partials at a ring step; B2 at B 2
    x S 2048, window 1024), each with its bound and SDPA's time where SDPA
    takes the shape; inputs at the port's pitch, so no copy is timed. Each
    entry's "pitch_cost" holds the same kernel's ms at D 104 (two-byte) or D
    48 (one-byte), the next head dim whose rows need no pitch. Returns
    {row name: entry}."""
    from flash_attention_cute_tpu_torch.ops import _build
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    f = torch.nn.functional
    one_byte = ("quant_decode", "quant_paged_decode", "quant_paged_extend", "quant_append")

    def randn(*shape):
        return pitched(torch, torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))

    def rows_at(d, names):
        cfg = pitched_model_config(d)
        got = widths_rows(torch, ops, gen, cfg, chunked=True)
        return {n: e for n, e in got.items() if n in names}

    out = {}
    two_byte = ("flash_fwd", "decode_partials", "decode_combine", "paged_decode",
                "paged_extend", "paged_append", "flash_chunked")
    for names, d, unpitched in ((two_byte, 100, 104), (one_byte, 40, 48)):
        at, ref = rows_at(d, names), rows_at(unpitched, names)
        for n in names:
            out[n] = {**at[n], "shape": f"{at[n].get('shape', 'phase 4r')}, D {d}",
                      "pitch_cost": {"d": unpitched, "ms": ref[n]["ms"]}}

    def b2(d):
        q, k, v = randn(2, 32, 2048, d), randn(2, 8, 2048, d), randn(2, 8, 2048, d)
        fn = lambda: ops["flash_fwd"].flash_attention_fwd(q, k, v, causal=True, window=1024)
        kr, vr = (x.repeat_interleave(4, dim=1) for x in (k, v))
        mask = torch.ones(2048, 2048, dtype=torch.bool, device="cuda").tril()
        mask &= ~torch.ones_like(mask).tril(-1024)
        pairs = sum(min(m + 1, 1024) for m in range(2048))
        e = {"ms": cuda_time_ms(fn, 20), "call_ms": call_time_ms(fn, 20),
             "plain_ms": cuda_time_ms(lambda: ops["flash_fwd"].flash_attention_fwd_plain(
                 q, k, v, causal=True, window=1024), 3),
             "library_ms": cuda_time_ms(lambda: f.scaled_dot_product_attention(
                 q, kr, vr, attn_mask=mask), 20),
             **bound(4 * 2 * 32 * pairs * d, 2 * (2 * q.numel() + k.numel() + v.numel()),
                     PEAK_BF16), "shape": f"B 2, S 2048, window 1024, Hq 32, Hkv 8, D {d}"}
        return e

    out["flash_fwd_window"] = {**b2(100), "pitch_cost": {"d": 104, "ms": b2(104)["ms"]}}
    p_i8, k8 = int8_entry(torch, ops["flash_fwd"], gen, B, 32, 8, PROMPT, 100, None, None,
                          f"B {B}, S {PROMPT}, Hq 32, Hkv 8, D 100, causal")
    b2_i8, _ = int8_entry(torch, ops["flash_fwd"], gen, 1, 32, 8, 4096, 100, 2047, None,
                          "B 1, S 4096, window 2047, Hq 32, Hkv 8, D 100", iters=10)
    ref = [int8_entry(torch, ops["flash_fwd"], gen, B, 32, 8, PROMPT, 104, None, None, "",
                      plain=False)]
    ref.append(int8_entry(torch, ops["flash_fwd"], gen, 1, 32, 8, 4096, 104, 2047, None, "",
                          plain=False, iters=10))
    out["flash_fwd_int8"] = {**p_i8, "pitch_cost": {"d": 104, "ms": ref[0][0]["ms"]}}
    out["flash_fwd_window_int8"] = {**b2_i8, "pitch_cost": {"d": 104, "ms": ref[1][0]["ms"]}}
    out["quantize_k_rows"] = {**k8, "pitch_cost": {"d": 104, "ms": ref[0][1]["ms"]}}

    for d in (100, 104):
        bwd = bwd_timings(torch, ops, randn, 2, 32, 8, 2048, d)
        var = varlen_row(torch, ops["flash_varlen"], gen, 32, 8, d)
        for n, e in (*bwd.items(), ("flash_varlen", var)):
            if d == 100:
                e.pop("library", None)
                out[n] = {**e, "shape": f"{e.get('shape', 'B 2, S 2048, causal')}, Hq 32, "
                                        f"Hkv 8, D 100"}
            else:
                out[n]["pitch_cost"] = {"d": 104, "ms": e["ms"]}

    def partials(d):
        q, k, v, off, kvl = chunked_inputs(torch, gen, torch.bfloat16, 4096, 4096, [4096],
                                           [4096], d)
        fc = ops["flash_chunked"]
        fn = lambda: fc.flash_attention_chunked(q, k, v, off, kvl, causal=False,
                                                return_partials=True)
        pairs = 4096 * 4096
        return {"ms": cuda_time_ms(fn, 10), "call_ms": call_time_ms(fn, 10),
                "plain_ms": cuda_time_ms(lambda: fc.flash_attention_chunked_plain(
                    q, k, v, off, kvl, causal=False, return_partials=True), 3),
                "library_ms": None,
                **bound(4 * 32 * pairs * d, 2 * q.numel() + 2 * 2 * 8 * 4096 * d
                        + 4 * (q.numel() + 2 * 32 * 4096), PEAK_BF16),
                "shape": f"a non-causal ring step: B 1, S 4096 over 4096 keys, Hq 32, Hkv 8, "
                         f"D {d}"}

    out["flash_chunked_partials"] = {**partials(100), "pitch_cost": {"d": 104,
                                                                     "ms": partials(104)["ms"]}}
    torch.cuda.empty_cache()
    return out


def phi3_int8_rows(torch, flash_fwd, gen):
    """Phase 5k: the "phi3" entries of the P-i8, B2-i8 and K8 rows at phase
    3o's int8-score path (Phi-3-mini's 32 / 32 heads, D 96 in D 128's
    layout): P-i8 at B 4 x 512 causal, B2-i8 at B 1 x 4096 with the window
    of 2047, K8 on the K of P-i8's (`int8_entry`)."""
    p_i8, k8 = int8_entry(torch, flash_fwd, gen, B, 32, 32, PROMPT, 96, None, None,
                          f"B {B}, S {PROMPT}, Hq 32, Hkv 32, D 96, causal (phase 3o's path)")
    b2_i8, _ = int8_entry(torch, flash_fwd, gen, 1, 32, 32, PHI3_INT8_LONG, 96, PHI3_WINDOW,
                          None, f"B 1, S {PHI3_INT8_LONG}, window {PHI3_WINDOW}, Hq 32, Hkv 32, "
                          f"D 96 (phase 3o's path)", iters=10)
    return {"flash_fwd_int8": p_i8, "flash_fwd_window_int8": b2_i8, "quantize_k_rows": k8}


# Phase 5l: head dims from 257 to 512 in P / B2 (with the lse) and B12,
# which run them in the wide layout of 512 (csrc/attention_wgmma.cuh: a
# block computes 256 of O's columns, grid y picks which, recomputing S over
# the whole d; 32-key tiles), at DeepSeek-V4-Flash's attention widths
# (config.json: 64 q heads, 1 kv head, head_dim 512, sliding_window 128;
# bf16). JAX's API and model path refuse a head dim above 256 (as the
# port's `dispatch.validate_inputs` does), so no model runs: the path is
# the public kernel-level entry points `ops.flash_fwd.flash_attention_fwd`
# and `flash_attention_varlen`. The cap of 50 is not the config's: it
# covers the capped instantiation. The packed batch: 8 sequences of
# 517-4096 tokens, 16384 in all. Then d 260 (rows of 264), 320 and 384 at
# B 1 x 2048 and a packed batch of 4096 tokens, the same heads.
V4_LABEL = "v4-widths"
V4_HQ, V4_HKV, V4_D, V4_S, V4_WINDOW, V4_CAP = 64, 1, 512, 8192, 128, 50.0
V4_PACKED_LENS = [4096, 517, 2048, 1000, 3072, 1531, 2560, 1560]
V4_SMALL_DIMS, V4_SMALL_S, V4_SMALL_LENS = (260, 320, 384), 2048, [1024, 1, 700, 371, 2000]


def v4_randn(torch, gen, *shape):
    """bf16 normal values at the port's row pitch (`pitched`)."""
    return pitched(torch, torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))


def cu_seqlens(torch, lens):
    return torch.tensor([0] + list(lens), device="cuda").cumsum(0).to(torch.int32)


def held_varlen(torch, flash_varlen, errs, what, q, k, v, cu, out=None, tag=V4_LABEL):
    """B12 through `flash_attention_varlen` (causal) against its fp32 plain
    version (`varlen_plain`), within BF16_TOL and finite, a second call (or
    `out`, a call made before) repeated bit for bit."""
    from flash_attention_cute_tpu_torch import flash_attention_varlen

    got = flash_attention_varlen(q, k, v, cu, causal=True)
    ref = varlen_plain(torch, flash_varlen, q, k, v, cu, cu, causal=True)
    e = max_err(got, ref)
    same = torch.equal(got, out if out is not None else flash_attention_varlen(q, k, v, cu,
                                                                               causal=True))
    note_err(errs, "flash_varlen", e, tag)
    print(f"  {what}: max|diff| {e:.3e}, repeated bit for bit: {same}")
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(e <= BF16_TOL, f"{what} within {BF16_TOL}")
    check(same, f"{what}: repeated bit for bit")


def phase_v4_widths(torch, ops, kernels, path_counts, errs):
    """Phase 5l's checks and path: the entry points at DeepSeek-V4-Flash's
    widths on path "v4-widths" (P causal at B 1 x 8192 with and without the
    lse, B2 with the window of 128 and with the cap 50 too, B12 over the
    packed batch: P 2, B2 2, B12 1, nothing else), each output within
    BF16_TOL of its fp32 plain version (the lse within LSE_TOL) and equal to
    a second call; then d 260, 320 and 384 alike at the smaller size."""
    from flash_attention_cute_tpu_torch import flash_attention_varlen

    flash_fwd, flash_varlen = ops["flash_fwd"], ops["flash_varlen"]
    gen = torch.Generator(device="cuda").manual_seed(4396)
    q, k, v = (v4_randn(torch, gen, 1, h, V4_S, V4_D) for h in (V4_HQ, V4_HKV, V4_HKV))
    cu = cu_seqlens(torch, V4_PACKED_LENS)
    pq, pk, pv = (v4_randn(torch, gen, int(cu[-1]), h, V4_D) for h in (V4_HQ, V4_HKV, V4_HKV))
    fwd = flash_fwd.flash_attention_fwd
    outs, wall, counts = counted_run(torch, kernels, lambda: (
        fwd(q, k, v, causal=True), fwd(q, k, v, causal=True, return_lse=True),
        fwd(q, k, v, causal=True, window=V4_WINDOW),
        fwd(q, k, v, causal=True, window=V4_WINDOW, logit_softcap=V4_CAP),
        flash_attention_varlen(pq, pk, pv, cu, causal=True)))
    path_counts[V4_LABEL] = counts
    print(f"  path {V4_LABEL!r}: P causal (and with its lse) and B2 (window {V4_WINDOW}, also "
          f"with the cap {V4_CAP}) at B 1 x {V4_S}, {V4_HQ} / {V4_HKV} heads, D {V4_D}; B12 over "
          f"{len(V4_PACKED_LENS)} sequences ({int(cu[-1])} tokens): {wall * 1e3:.1f} ms (host "
          f"clock), launches { {n: c for n, c in counts.items() if c} }")
    check_launched(counts, {"flash_fwd": 2, "flash_fwd_window": 2, "flash_varlen": 1},
                   f"path {V4_LABEL}")
    check(all(tuple(o.shape) == tuple(q.shape) for o in (outs[0], outs[1][0], outs[2], outs[3]))
          and tuple(outs[1][1].shape) == tuple(q.shape[:3])
          and tuple(outs[4].shape) == tuple(pq.shape), f"path {V4_LABEL}: output shapes")
    for (what, window, cap), path_out in zip(
            (("P causal", None, None), ("B2 window", V4_WINDOW, None),
             ("B2 window, cap", V4_WINDOW, V4_CAP)), (outs[1][0], outs[2], outs[3])):
        out = held_prefill(torch, flash_fwd, errs, f"{V4_LABEL} {what} D {V4_D}", q, k, v, True,
                           window, cap, tag=V4_LABEL, step=8)
        check(torch.equal(out, path_out) and (window or torch.equal(out, outs[0])),
              f"{V4_LABEL} {what}: the path's calls repeat bit for bit")
        del out
        torch.cuda.empty_cache()
    held_varlen(torch, flash_varlen, errs, f"{V4_LABEL} B12 D {V4_D}", pq, pk, pv, cu, outs[4])
    del q, k, v, pq, pk, pv, outs
    torch.cuda.empty_cache()
    cu = cu_seqlens(torch, V4_SMALL_LENS)
    for d in V4_SMALL_DIMS:
        q, k, v = (v4_randn(torch, gen, 1, h, V4_SMALL_S, d) for h in (V4_HQ, V4_HKV, V4_HKV))
        held_prefill(torch, flash_fwd, errs, f"P causal D {d} (rows of {q.stride(-2)})", q, k, v,
                     True, None, tag=V4_LABEL)
        held_prefill(torch, flash_fwd, errs, f"B2 window {V4_WINDOW}, cap {V4_CAP}, D {d}", q, k,
                     v, True, V4_WINDOW, V4_CAP, tag=V4_LABEL)
        pq, pk, pv = (v4_randn(torch, gen, int(cu[-1]), h, d) for h in (V4_HQ, V4_HKV, V4_HKV))
        held_varlen(torch, flash_varlen, errs, f"B12 D {d}, {len(V4_SMALL_LENS)} sequences "
                    f"({int(cu[-1])} tokens)", pq, pk, pv, cu)
        del q, k, v, pq, pk, pv
    torch.cuda.empty_cache()


def sdpa_entry(torch, q, k, v, **kw) -> dict:
    """library_ms of one SDPA call over q and k / v expanded to q's heads
    (bf16), and "library": the backend torch picks there
    (`torch._fused_sdp_choice`), or null with the reason where SDPA raises."""
    from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms

    f = torch.nn.functional
    kx, vx = (x.repeat_interleave(q.shape[1] // x.shape[1], dim=1) for x in (k, v))
    try:
        from torch.nn.attention import SDPBackend

        backend = SDPBackend(torch._fused_sdp_choice(q, kx, vx, kw.get("attn_mask"), 0.0,
                                                     kw.get("is_causal", False))).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as err:  # a private call
        backend = f"not named ({type(err).__name__})"
    try:
        ms = cuda_time_ms(lambda: f.scaled_dot_product_attention(q, kx, vx, **kw), 3, warmup=1)
        out = {"library_ms": ms, "library": f"SDPA, backend {backend}, group expanded"}
    except RuntimeError as err:  # no SDPA backend of the card takes the shape
        out = {"library_ms": None, "library": f"null: SDPA raised ({str(err)[:160]})"}
    del kx, vx
    torch.cuda.empty_cache()
    return out


def v4_rows(torch, ops, gen, path_counts, errs, reports):
    """Phase 5l's numbers: the "v4" entries of the P, B2 and B12 rows at the
    path's shapes: ms, call_ms, the fp32 plain version's ms (8 q heads at a
    time; B12's per sequence), SDPA's ms and backend (`sdpa_entry`: P
    is_causal; B2 with the window as a boolean mask; B12 over the batch
    padded to [8, 64, 4096, 512], is_causal, padding computed too), the
    bound (4 D operations a visible pair and q head at the bf16 rate, or q,
    k, v and the output once at 3.35 TB/s), P's time with its lse and B2's
    with the cap, the runtime attributes of the D 512 instantiation, the
    errors and launches of path "v4-widths"."""
    from flash_attention_cute_tpu_torch import flash_attention_varlen
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    flash_fwd, flash_varlen = ops["flash_fwd"], ops["flash_varlen"]
    fwd_report, b12_report = reports
    q, k, v = (v4_randn(torch, gen, 1, h, V4_S, V4_D) for h in (V4_HQ, V4_HKV, V4_HKV))
    io = 2 * (2 * q.numel() + k.numel() + v.numel())
    heads = f"Hq {V4_HQ}, Hkv {V4_HKV}, D {V4_D} (DeepSeek-V4-Flash's attention)"
    out = {}
    for name, window, pairs in (
            ("flash_fwd", None, V4_S * (V4_S + 1) // 2),
            ("flash_fwd_window", V4_WINDOW, sum(min(m + 1, V4_WINDOW) for m in range(V4_S)))):
        def fn(cap=None, lse=False, window=window):
            return flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=window,
                                                 logit_softcap=cap, return_lse=lse)

        def plain(window=window):
            return by_kv_head(torch, lambda q_, k_, v_: flash_fwd.flash_attention_fwd_plain(
                q_.float(), k_.float(), v_.float(), causal=True, window=window), q, k, v, 8)

        if window:
            mask = torch.ones(V4_S, V4_S, dtype=torch.bool, device="cuda").tril()
            mask &= ~torch.ones_like(mask).tril(-window)
            lib = sdpa_entry(torch, q, k, v, attn_mask=mask)
            del mask
        else:
            lib = sdpa_entry(torch, q, k, v, is_causal=True)
        e = {"shape": f"B 1, S {V4_S}, causal" + (f", window {window}" if window else "")
                      + f", {heads}",
             "ms": cuda_time_ms(fn, 10), "call_ms": call_time_ms(fn, 10),
             "plain_ms": cuda_time_ms(plain, 2, warmup=1), **lib,
             **bound(4 * V4_D * V4_HQ * pairs, io, PEAK_BF16),
             "max_abs_err": errs[f"{name} {V4_LABEL}"],
             "launches": path_counts[V4_LABEL][name]}
        if window:
            e["cap_ms"] = cuda_time_ms(lambda: fn(cap=V4_CAP), 10)
            e["runtime_attributes"] = runtime_attributes(fwd_report, "P / B2 D512 bf16")
            e["cap_runtime_attributes"] = runtime_attributes(fwd_report, "P / B2 D512 bf16 cap")
        else:
            e["lse_ms"] = cuda_time_ms(lambda: fn(lse=True), 10)
            e["lse_max_abs_err"] = errs[f"{name} {V4_LABEL} lse"]
            e["runtime_attributes"] = runtime_attributes(fwd_report, "P / B2 D512 bf16")
        out[name] = e
    del q, k, v
    torch.cuda.empty_cache()

    lens = V4_PACKED_LENS
    cu = cu_seqlens(torch, lens)
    q, k, v = (v4_randn(torch, gen, int(cu[-1]), h, V4_D) for h in (V4_HQ, V4_HKV, V4_HKV))
    seg, pos = flash_varlen._seg_metadata(cu, q.shape[0])
    qp, kp, vp = (torch.zeros((len(lens), h, max(lens), V4_D), dtype=torch.bfloat16,
                              device="cuda") for h in (V4_HQ, V4_HKV, V4_HKV))
    for i, n in enumerate(lens):
        a = int(cu[i])
        for dst, src in ((qp, q), (kp, k), (vp, v)):
            dst[i, :, :n] = src[a:a + n].transpose(0, 1)
    pairs = sum(n * (n + 1) // 2 for n in lens)

    def run():
        return flash_attention_varlen(q, k, v, cu, causal=True)

    out["flash_varlen"] = {
        "shape": f"{len(lens)} sequences of {min(lens)}-{max(lens)} tokens ({q.shape[0]} "
                 f"packed), causal, {heads}; library_ms: SDPA over the batch padded to "
                 f"[{len(lens)}, {V4_HQ}, {max(lens)}, {V4_D}], padding computed too",
        "ms": cuda_time_ms(run, 10), "call_ms": call_time_ms(run, 10),
        "plain_ms": cuda_time_ms(lambda: flash_varlen.flash_attention_packed_plain(
            q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), seg, seg, pos, pos,
            causal=True), 2, warmup=1),
        **sdpa_entry(torch, qp, kp, vp, is_causal=True),
        **bound(4 * V4_D * V4_HQ * pairs,
                2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * 4 * q.shape[0], PEAK_BF16),
        "max_abs_err": errs[f"flash_varlen {V4_LABEL}"],
        "launches": path_counts[V4_LABEL]["flash_varlen"],
        "runtime_attributes": runtime_attributes(b12_report, "B12 D512 bf16")}
    del q, k, v, qp, kp, vp
    torch.cuda.empty_cache()
    return out


# Phase 5m: head dims from 257 to 512 in B4 (with its (o, m, l) partials)
# and B6, which run them in the wide layout of 512 as P does, and
# sequence-parallel attention over B4, at DeepSeek-V4-Flash's attention
# widths (64 / 1 heads, D 512, bf16, the config's window of 128), on path
# "v4-extend" through the public kernel-level entry points
# `ops.flash_chunked.flash_attention_chunked`,
# `ops.paged_attention.paged_attention_extend` and the ring / all-gather of
# `parallel.sequence` (no model: JAX's API and model path refuse a head dim
# above 256, as the port's do). B4 at B 1 over a contiguous cache of 8192
# keys: a prefill chunk of 1024 rows at q_offset 7168, causal and with the
# window, and a verify-size chunk of 5 rows at kv_length 8192 (16 q heads a
# block), each also as partials; B6 at B 4, a chunk of 512 rows a row at
# offsets 0-3584, pages of 16 and 64 tokens behind a shuffled table, NaN
# past every length, once with the window. V4X_SP: the ring (causal
# zig-zag, non-causal) and the all-gather (the window) unrolled over 8
# ranks at 16384 tokens (path "v4-extend sp"), at 2048 over 4 ranks against
# the fp32 plain dense reference, the entry points over a one-rank NCCL
# mesh at 4096 (path "v4-extend nccl"). Then d 260 (rows of 264), 320 and
# 384 at a small size.
V4X_LABEL = "v4-extend"
V4X_CACHE, V4X_CHUNK, V4X_VERIFY = 8192, 1024, 5
V4X_PAGED_OFFS, V4X_PAGED_S, V4X_PAGED_CAP, V4X_PAGE_SIZES = [0, 1200, 2400, 3584], 512, 4096, (
    16, 64)
V4X_SP = SpShape((V4_HQ, V4_HKV), V4_D, 16384, 8, 2048, 4, 4096, V4_WINDOW, V4_WINDOW, 8,
                 "v4-extend sp", "v4-extend nccl", 4399)
# The small head dims: a cache of 2048, a chunk of 256 rows, B6 at B 4 x 128
# rows, the ring over 4 ranks at 1024 tokens.
V4X_SMALL_CACHE, V4X_SMALL_CHUNK, V4X_SMALL_PAGED_S, V4X_SMALL_SP_S = 2048, 256, 128, 1024
V4X_SMALL_PAGED_OFFS = [0, 500, 1000, 1920]
# ROW_TOL's reach: B4's chunk at D 512 against its plain version with the
# keys of one 32-key V tile zeroed, and with one key past the diagonal.
V4X_ZEROED_KEYS = (4096, 4128)


def v4x_ints(torch, *values):
    """int32 tensors on the card, one a value (an int: [1])."""
    return [torch.tensor([x] if isinstance(x, int) else list(x), dtype=torch.int32,
                         device="cuda") for x in values]


def v4x_contiguous(torch, gen, d, cache, chunk):
    """A chunk's q [1, 64, chunk, d], a verify round's [1, 64, 5, d] and
    the cache's k, v [1, 1, cache, d], bf16 at the port's pitch."""
    q, qv = (v4_randn(torch, gen, 1, V4_HQ, s, d) for s in (chunk, V4X_VERIFY))
    k, v = (v4_randn(torch, gen, 1, V4_HKV, cache, d) for _ in "kv")
    return q, qv, k, v


def v4x_pool(torch, gen, ps, d, lengths, capacity):
    """One layer's pools [1, P, ps, d] (bf16 at the port's pitch, NaN at and
    past every row's length and in page 0) and their shuffled table, for
    len(lengths) rows of `capacity` keys."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    kp, vp, table = paged_pool(torch, randn, gen, ps, len(lengths), capacity, layers=1, d=d,
                               hkv=V4_HKV)
    lens, = v4x_ints(torch, lengths)
    for pool in (kp, vp):
        poison_past(torch, pool, table, lens)
    return kp[0], vp[0], table


def v4x_chunked_plain(torch, fc, q, k, v, off, kvl, **kw):
    """B4's fp32 plain version over q's fp32 image, 8 q heads at a time."""
    return by_kv_head(torch, lambda q_, k_, v_: fc.flash_attention_chunked_plain(
        q_.float(), k_, v_, off, kvl, **kw), q, k, v, 8)


def v4x_paged_plain(torch, pa, q, kp, vp, off, kvl, table, **kw):
    """B6's fp32 plain version over q's fp32 image, 8 q heads at a time."""
    return by_kv_head(torch, lambda q_, k_, v_: pa.paged_attention_extend_plain(
        q_.float(), k_, v_, off, kvl, table, **kw), q, kp, vp, 8, kv_dim=0)


def v4x_extend_calls(torch, ops, gen, d, cache, chunk, paged_s, offs, capacity, page_sizes):
    """{name: (kernel name, call, its fp32 plain version)} of B4 (the chunk
    causal and windowed, the verify round, the partials of both) and B6 (a
    chunk of `paged_s` rows at each of `offs`, rows of `capacity` keys, each
    page size, once more windowed) at head dim d, and B4's chunk inputs (q,
    k, v, q_offset, kv_length)."""
    fc, pa = ops["flash_chunked"], ops["paged_attention"]
    q, qv, k, v = v4x_contiguous(torch, gen, d, cache, chunk)
    off, off_v, kvl = v4x_ints(torch, cache - chunk, cache - V4X_VERIFY, cache)
    lengths = [o + paged_s for o in offs]
    p_off, p_kvl = v4x_ints(torch, offs, lengths)
    qp = v4_randn(torch, gen, len(offs), paged_s, V4_HQ, d).transpose(1, 2)
    pools = {ps: v4x_pool(torch, gen, ps, d, lengths, capacity) for ps in page_sizes}

    def chunked(x, o, **kw):
        return (lambda: fc.flash_attention_chunked(x, k, v, o, kvl, **kw),
                lambda: v4x_chunked_plain(torch, fc, x, k, v, o, kvl, **kw))

    def paged(ps, **kw):
        kp, vp, table = pools[ps]
        return (lambda: pa.paged_attention_extend(qp, kp, vp, p_off, p_kvl, table, **kw),
                lambda: v4x_paged_plain(torch, pa, qp, kp, vp, p_off, p_kvl, table, **kw))

    calls = {
        f"B4 chunk of {chunk} at q_offset {cache - chunk}": ("flash_chunked", *chunked(q, off)),
        f"B4 chunk, window {V4_WINDOW}": ("flash_chunked", *chunked(q, off, window=V4_WINDOW)),
        f"B4 verify round of {V4X_VERIFY}": ("flash_chunked", *chunked(qv, off_v)),
        "B4-partials chunk": ("flash_chunked_partials", *chunked(q, off, return_partials=True)),
        "B4-partials verify round": ("flash_chunked_partials",
                                     *chunked(qv, off_v, return_partials=True)),
    }
    for ps in page_sizes:
        calls[f"B6 pages of {ps}"] = ("paged_extend", *paged(ps))
    calls[f"B6 pages of {page_sizes[0]}, window {V4_WINDOW}"] = (
        "paged_extend", *paged(page_sizes[0], window=V4_WINDOW))
    return calls, (q, k, v, off, kvl)


def phase_v4_extend(torch, ops, kernels, path_counts, errs):
    """Phase 5m's checks and paths (the constants above): path "v4-extend"
    counted exactly (B4 3, B4-partials 2, B6 3, nothing else), each output
    held by `held_rows` to its fp32 plain version (8 q heads at a time) and
    to a second call; ROW_TOL's reach: B4's chunk against its plain version
    over V4X_ZEROED_KEYS zeroed in V, and with one key past the diagonal,
    row_err above ROW_TOL (max |diff| printed beside it); a wholly-future
    chunk's partials m = l = o = 0; `phase_sequence_parallel` at V4X_SP;
    then d 260, 320 and 384 alike at the small size, the ring by
    `sp_reference_checks`. Returns the sequence-parallel errors and the
    reach."""
    from flash_attention_cute_tpu_torch.ops import _build

    fc = ops["flash_chunked"]
    gen = torch.Generator(device="cuda").manual_seed(4398)
    d = V4_D
    calls, (q, k, v, off, kvl) = v4x_extend_calls(torch, ops, gen, d, V4X_CACHE, V4X_CHUNK,
                                                  V4X_PAGED_S, V4X_PAGED_OFFS, V4X_PAGED_CAP,
                                                  V4X_PAGE_SIZES)
    outs, wall, counts = counted_run(torch, kernels, lambda: {
        name: call() for name, (_, call, _) in calls.items()})
    add_counts(path_counts.setdefault(V4X_LABEL, {}), counts)
    print(f"  path {V4X_LABEL!r}: B4 (chunk of {V4X_CHUNK} at q_offset {V4X_CACHE - V4X_CHUNK}, "
          f"causal and window {V4_WINDOW}; verify round of {V4X_VERIFY}; their partials) over "
          f"B 1 x {V4X_CACHE} keys, B6 (B {len(V4X_PAGED_OFFS)} x {V4X_PAGED_S} rows at "
          f"{V4X_PAGED_OFFS}, pages of {V4X_PAGE_SIZES}, window {V4_WINDOW}), {V4_HQ} / "
          f"{V4_HKV} heads, D {d}: {wall * 1e3:.1f} ms (host clock), launches "
          f"{ {name: c for name, c in counts.items() if c} }")
    check_launched(counts, {"flash_chunked": 3, "paged_extend": 3, "flash_chunked_partials": 2},
                   f"path {V4X_LABEL}")
    for name, (key, call, plain) in calls.items():
        held_rows(torch, errs, f"{V4X_LABEL} {name} D {d}", key, V4X_LABEL, outs[name], plain(),
                  call())
    del outs, calls
    reach = {}
    got = fc.flash_attention_chunked(q, k, v, off, kvl)
    zeroed = v.clone()
    zeroed[:, :, slice(*V4X_ZEROED_KEYS)] = 0
    for fault, ref in (
            (f"V zero at keys {V4X_ZEROED_KEYS[0]}-{V4X_ZEROED_KEYS[1] - 1}",
             v4x_chunked_plain(torch, fc, q, k, zeroed, off, kvl)),
            ("one key past the causal diagonal",
             v4x_chunked_plain(torch, fc, q, k, v, off + 1, kvl))):
        reach[fault] = {"max_abs_err": max_err(got, ref), "row_err": row_err(got, ref)}
        print(f"  ROW_TOL's reach: B4's chunk D {d} against its plain version with {fault}: "
              f"max|diff| {reach[fault]['max_abs_err']:.3e} (BF16_TOL {BF16_TOL}), row_err "
              f"{reach[fault]['row_err']:.3e} (ROW_TOL {ROW_TOL})")
        check(reach[fault]["row_err"] > ROW_TOL, f"{V4X_LABEL}: row_err sees B4's chunk held "
                                                 f"to a plain version with {fault}")
        del ref
    fut, = v4x_ints(torch, -V4X_CHUNK)
    future = fc.flash_attention_chunked(q, k, v, fut, kvl, return_partials=True)
    dead = all(bool((x == 0).all()) for x in future)
    print(f"  {V4X_LABEL} B4-partials, a wholly-future chunk (q_offset -{V4X_CHUNK}): m = l = o = "
          f"0: {dead}")
    check(dead, f"{V4X_LABEL}: a wholly-future chunk's partials are m = l = o = 0")
    del got, zeroed, future, q, k, v
    torch.cuda.empty_cache()

    numbers = phase_sequence_parallel(torch, ops["flash_fwd"], kernels, path_counts, errs,
                                      V4X_SP)
    for dd in V4_SMALL_DIMS:
        calls, _ = v4x_extend_calls(torch, ops, gen, dd, V4X_SMALL_CACHE, V4X_SMALL_CHUNK,
                                    V4X_SMALL_PAGED_S, V4X_SMALL_PAGED_OFFS, V4X_SMALL_CACHE,
                                    (16,))
        for name, (key, call, plain) in calls.items():
            held_rows(torch, errs, f"{name} D {dd}", key, V4X_LABEL, call(), plain(), call(),
                      _build.row_pitch(dd))
        del calls
        sp_reference_checks(torch, errs, gen, V4X_SP._replace(d=dd, check_s=V4X_SMALL_SP_S))
    torch.cuda.empty_cache()
    return numbers, reach


def timed_v4(fn, plain, iters) -> dict:
    """The "ms" and "call_ms" of `iters` calls of fn and its plain
    version's ms (2 calls after one warm-up), as phases 5m / 5n time."""
    from flash_attention_cute_tpu_torch.utils.timing import call_time_ms, cuda_time_ms

    return {"ms": cuda_time_ms(fn, iters), "call_ms": call_time_ms(fn, iters),
            "plain_ms": cuda_time_ms(plain, 2, warmup=1)}


def v4x_rows(torch, ops, gen, path_counts, errs, reports):
    """Phase 5m's numbers: the "v4" entries of the B4, B4-partials and B6
    rows at path "v4-extend"'s shapes: ms, call_ms, the fp32 plain
    version's ms (8 q heads at a time), library_ms (`sdpa_entry`: SDPA with
    the visibility as a boolean mask, k / v expanded to the 64 q heads, the
    backend torch picks at D 512; B6's over a contiguous gathered copy;
    null for the partials, which no PyTorch call returns), the bound (4 D
    operations a visible pair and q head at the bf16 rate, or q, the keys
    some row sees and the output once at 3.35 TB/s), the D 512
    instantiation's runtime attributes, the errors (max |diff| and
    `row_err`) of path "v4-extend" and the launches of paths "v4-extend",
    "v4-extend sp" and "v4-extend nccl"; B4's and its partials' verify
    round under "verify", B4's and B6's window under "window", B6 at pages
    of 64 under "page64"; under the partials' "sequence_parallel"
    `sp_times` at V4X_SP."""
    fc, pa, flash_fwd = ops["flash_chunked"], ops["paged_attention"], ops["flash_fwd"]
    b4_report, b6_report = reports
    d = V4_D
    heads = f"Hq {V4_HQ}, Hkv {V4_HKV}, D {d} (DeepSeek-V4-Flash's attention)"
    q, qv, k, v = v4x_contiguous(torch, gen, d, V4X_CACHE, V4X_CHUNK)
    kvl, = v4x_ints(torch, V4X_CACHE)

    def visible(o0, rows, length, window):
        """Visible (row, key) pairs of rows at positions o0.., and the keys
        some row sees (each read once)."""
        lo = [max(0, o0 + r - window + 1) if window else 0 for r in range(rows)]
        hi = [min(length, o0 + r + 1) for r in range(rows)]
        return sum(max(0, h - l) for l, h in zip(lo, hi)), max(hi) - min(lo)

    def chunk_entry(x, window=None, partials=False, iters=10):
        s = x.shape[2]
        o0 = V4X_CACHE - s
        off, = v4x_ints(torch, o0)
        kw = dict(window=window, return_partials=partials)
        pairs, live = visible(o0, s, V4X_CACHE, window)
        rows = x.numel() // d
        out_bytes = 4 * x.numel() + 2 * 4 * rows if partials else 2 * x.numel()
        e = {"shape": f"B 1, S {s}, q_offset {o0}, kv_length {V4X_CACHE}, causal"
                      + (f", window {window}" if window else "") + f", {heads}",
             **timed_v4(lambda: fc.flash_attention_chunked(x, k, v, off, kvl, **kw),
                     lambda: v4x_chunked_plain(torch, fc, x, k, v, off, kvl, **kw), iters),
             **bound(4 * d * V4_HQ * pairs, 2 * x.numel() + out_bytes
                     + 2 * 2 * V4_HKV * d * live + 2 * 4, PEAK_BF16)}
        if partials:
            e.update(library_ms=None, library="null: no PyTorch call returns the (o, m, l) "
                                              "partials")
            return e
        cols = torch.arange(V4X_CACHE, device="cuda")[None, :]
        pos = o0 + torch.arange(s, device="cuda")[:, None]
        mask = cols <= pos
        if window:
            mask &= cols > pos - window
        e.update(sdpa_entry(torch, x, k, v, attn_mask=mask))
        return e

    def extend_extra(name):
        return {"max_abs_err": errs[f"{name} {V4X_LABEL}"],
                "max_row_err": errs[f"{name} row_err {V4X_LABEL}"], "launches": sum(
                    path_counts[p][name] for p in (V4X_LABEL, V4X_SP.label, V4X_SP.nccl_label))}

    out = {"flash_chunked": {
        **chunk_entry(q), "window": chunk_entry(q, window=V4_WINDOW),
        "verify": chunk_entry(qv, iters=50), **extend_extra("flash_chunked"),
        "runtime_attributes": runtime_attributes(b4_report, "B4 D512 bf16")}}
    out["flash_chunked_partials"] = {
        **chunk_entry(q, partials=True), "verify": chunk_entry(qv, partials=True, iters=50),
        **extend_extra("flash_chunked_partials"),
        "runtime_attributes": runtime_attributes(b4_report, "B4 D512 bf16 partials")}
    del q, qv, k, v
    torch.cuda.empty_cache()

    lengths = [o + V4X_PAGED_S for o in V4X_PAGED_OFFS]
    p_off, p_kvl = v4x_ints(torch, V4X_PAGED_OFFS, lengths)
    qp = v4_randn(torch, gen, len(lengths), V4X_PAGED_S, V4_HQ, d).transpose(1, 2)

    def paged_entry(ps, window=None, iters=10):
        kp, vp, table = v4x_pool(torch, gen, ps, d, lengths, V4X_PAGED_CAP)
        kw = dict(window=window)
        pairs, live, pages = 0, 0, 0
        for o0, n in zip(V4X_PAGED_OFFS, lengths):
            p_, l_ = visible(o0, V4X_PAGED_S, n, window)
            pairs, live = pairs + p_, live + l_
            pages += -(-n // ps) - (n - l_) // ps
        e = {"shape": f"B {len(lengths)}, S {V4X_PAGED_S}, q_offset {V4X_PAGED_OFFS}, page_size "
                      f"{ps}" + (f", window {window}" if window else "") + f", {heads}; "
                      "library_ms: SDPA over a contiguous gathered copy",
             **timed_v4(lambda: pa.paged_attention_extend(qp, kp, vp, p_off, p_kvl, table, **kw),
                     lambda: v4x_paged_plain(torch, pa, qp, kp, vp, p_off, p_kvl, table, **kw),
                     iters),
             **bound(4 * d * V4_HQ * pairs, 2 * 2 * qp.numel() + 2 * 2 * V4_HKV * d * live
                     + 4 * (2 * len(lengths) + pages), PEAK_BF16)}
        kc, vc = (pa.gather_pages(x, table).nan_to_num() for x in (kp, vp))
        cols = torch.arange(V4X_PAGED_CAP, device="cuda")[None, None, :]
        pos = p_off[:, None, None] + torch.arange(V4X_PAGED_S, device="cuda")[None, :, None]
        mask = (cols <= pos) & (cols < p_kvl[:, None, None])
        if window:
            mask &= cols > pos - window
        e.update(sdpa_entry(torch, qp, kc, vc, attn_mask=mask[:, None]))
        del kp, vp, kc, vc, mask
        return e

    out["paged_extend"] = {
        **paged_entry(16), "page64": paged_entry(64), "window": paged_entry(16, V4_WINDOW),
        **extend_extra("paged_extend"),
        "runtime_attributes": runtime_attributes(b6_report, "B6 bf16 D512")}
    del qp
    torch.cuda.empty_cache()

    out["flash_chunked_partials"]["sequence_parallel"] = sp_times(torch, flash_fwd, V4X_SP, gen)
    return out


# Phase 5n: head dims from 257 to 512 in the decodes D1, B5, B7 and B8
# (the wide layout of csrc/paged_decode.cuh: each consumer warp owns 256 of
# O's columns and computes S over the whole d; 16-key tiles), with D2, the
# paged append and QA, and in the quantized paged extend B9 (B6's wide
# layout), at DeepSeek-V4-Flash's attention widths (64 / 1 heads, D 512,
# bf16 q; the config's window of 128, and the cap of 50 of 5l), on path
# "v4-decode": the kernels a serving stream runs after admission, through
# the public kernel-level entry points (no model: JAX's API and model path
# refuse a head dim above 256, as the port's do). Over pools of 16- and
# 64-token pages of bf16, int8 and e4m3 values, B 4 rows admit prompts of
# V4D_PROMPTS tokens one row at a time (the append or QA, then B6 or B9),
# then run V4D_STEPS decode steps, each writing every row's new K / V (the
# append or QA) and decoding through B5 or B8 and D2 twice: plainly, and
# with the window (pages of 16) or the cap (pages of 64). Over contiguous
# caches [1, B, 1, V4D_CACHE, D] filled to V4D_CONTIG_LENGTHS the same
# steps through D1 or B7 and D2, plainly and with both the window and the
# cap; their new K / V are written by indexing (bf16, as the model does)
# or QA. Pools and caches hold NaN at and past every length (one-byte
# ones: NaN scales and the e4m3 NaN byte). Then d 260 (rows of 264) and
# 320 at a small size, off the counted path.
V4D_LABEL = "v4-decode"
V4D_PROMPTS, V4D_STEPS, V4D_PAGE_SIZES = [4096, 2900, 1537, 517], 32, (16, 64)
V4D_CACHE, V4D_CONTIG_LENGTHS = 8192, [8160, 6001, 3000, 1]
V4D_KINDS = ("bfloat16", "int8", "float8_e4m3fn")
V4D_VARIANTS = {16: {"window": V4_WINDOW}, 64: {"logit_softcap": V4_CAP},
                "contiguous": {"window": V4_WINDOW, "logit_softcap": V4_CAP}}
# The small head dims: pages of 16 and a contiguous cache of 1024, 2 steps.
V4D_SMALL_PROMPTS, V4D_SMALL_STEPS, V4D_SMALL_CACHE = [300, 129, 17, 1], 2, 1024
# Each stream's kernels: (append, extend, decode), None where no kernel runs.
V4D_KERNELS = {("bfloat16", "paged"): ("paged_append", "paged_extend", "paged_decode"),
               ("bfloat16", "contiguous"): (None, None, "decode_partials"),
               ("one-byte", "paged"): ("quant_append", "quant_paged_extend",
                                       "quant_paged_decode"),
               ("one-byte", "contiguous"): ("quant_append", None, "quant_decode")}


def raw_bits(torch, x):
    """x's elements as integers of their width: equal bits compare equal,
    NaN too."""
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()])


class V4Stream(NamedTuple):
    """One decode stream of phase 5n: its values' `kind`, its page size
    `ps` (or "contiguous"), its K and V (one layer's pools, or a stacked
    cache [1, B, Hkv, C, d]; QuantizedKV for one-byte values) and page
    table (None for a cache), copies of K and V as they stood before the
    path ran (the plain appends replay the path on them), each row's prompt
    length and (q, new K, new V) of its admission, and each step's q, new K,
    new V and lengths before the step."""
    kind: str
    ps: object
    k: object
    v: object
    table: object
    k0: object
    v0: object
    prompts: list
    admit: list
    steps: list

    def kernels(self):
        """(append, extend, decode) kernel names of the stream."""
        return V4D_KERNELS[("bfloat16" if self.kind == "bfloat16" else "one-byte",
                            "contiguous" if self.ps == "contiguous" else "paged")]


def v4d_stream(torch, qz, gen, kind, ps, d, prompts, steps, capacity):
    """A stream's inputs: pools NaN-poisoned everywhere (the admission
    fills them), or a cache filled to `prompts` and NaN past them; every
    row's prompt and every step's tensors (bf16 at the port's pitch)."""
    b = len(prompts)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    lens, = v4x_ints(torch, prompts)
    if ps == "contiguous":
        if kind == "bfloat16":
            k, v = (v4_randn(torch, gen, 1, b, V4_HKV, capacity, d) for _ in "kv")
            for x in (k, v):
                for row, n in enumerate(prompts):
                    x[:, row, :, n:] = float("nan")
        else:
            k, v = (qz.quantize_kv(randn(1, b, V4_HKV, capacity, d), getattr(torch, kind))
                    for _ in "kv")
            k, v = (qz.QuantizedKV(pitched(torch, x.values), x.scales) for x in (k, v))
            dead = torch.arange(capacity, device="cuda")[None, :] >= lens[:, None]
            for x in (k, v):
                poison_quant(torch, x, dead[None, :, None, :].expand(1, -1, V4_HKV, -1))
        table, admit = None, []
    else:
        pps = -(-capacity // ps)
        none, = v4x_ints(torch, [0] * b)
        if kind == "bfloat16":
            kp, vp, table = paged_pool(torch, randn, gen, ps, b, pps * ps, layers=1, d=d,
                                       hkv=V4_HKV)
            for x in (kp, vp):
                poison_past(torch, x, table, none)
            k, v = kp[0], vp[0]
        else:
            k, v, table = quant_pool(torch, qz, randn, gen, ps, b, getattr(torch, kind),
                                     [0] * b, pps * ps, d, V4_HKV)
        admit = [(v4_randn(torch, gen, 1, n, V4_HQ, d).transpose(1, 2),
                  *(v4_randn(torch, gen, 1, n, V4_HKV, d).transpose(1, 2) for _ in "kv"))
                 for n in prompts]
    steps_in = [(v4_randn(torch, gen, b, V4_HQ, 1, d),
                 *(v4_randn(torch, gen, b, 1, V4_HKV, d).transpose(1, 2) for _ in "kv"),
                 lens + t) for t in range(steps)]
    if kind == "bfloat16":
        k0, v0 = k.clone(), v.clone()
    else:
        k0, v0 = (qz.QuantizedKV(x.values.clone(), x.scales.clone()) for x in (k, v))
    return V4Stream(kind, ps, k, v, table, k0, v0, prompts, admit, steps_in)


def v4d_append(torch, ops, paged_cache, s, k, v, nk, nv, lens, table, plain=False):
    """Write new K / V rows at `lens` into (k, v), the stream's K / V or
    their copies: the append (bf16 pages) or QA (one-byte values), or with
    `plain` their plain versions; a bf16 cache by indexing, as the model
    writes it."""
    qz = ops["quantized"]
    if s.kind != "bfloat16":
        if s.ps == "contiguous":  # one layer's views
            k, v = (qz.QuantizedKV(x.values[0], x.scales[0]) for x in (k, v))
        fn = qz.quantize_append_plain if plain else qz.quantize_append
        fn(nk, nv, k, v, lens, table)
    elif s.ps == "contiguous":
        rows = torch.arange(len(lens), device="cuda")[:, None]
        heads = torch.arange(V4_HKV, device="cuda")[None, :]
        for x, new in ((k, nk), (v, nv)):
            x[0][rows, heads, lens.long()[:, None]] = new[:, :, 0]
    else:
        fn = paged_cache.paged_append_layer_plain if plain else paged_cache.paged_append_layer
        fn(k, v, nk, nv, table, lens)


def v4d_decode(torch, ops, s, q, lens, plain=False, **kw):
    """The stream's decode of q over the keys below `lens`: B5 / B8 (pages)
    or D1 / B7 (a cache), each with D2; with `plain` its fp32 plain version
    on q's fp32 image."""
    qz, pa, fd = ops["quantized"], ops["paged_attention"], ops["flash_decode"]
    quant = s.kind != "bfloat16"
    q = q.float() if plain else q
    if s.ps == "contiguous":
        fn = ((qz.flash_attention_decode_quantized_plain if plain
               else qz.flash_attention_decode_quantized) if quant
              else fd.flash_attention_decode_plain if plain else fd.flash_attention_decode)
        return fn(q, s.k, s.v, lens, layer=0, **kw)
    fn = ((qz.paged_attention_decode_quantized_plain if plain
           else qz.paged_attention_decode_quantized) if quant
          else pa.paged_attention_decode_plain if plain else pa.paged_attention_decode)
    return fn(q, s.k, s.v, lens, s.table, **kw)


def v4d_extend(torch, ops, s, row, plain=False):
    """Row `row`'s admission: B6 / B9 over its prompt (q_offset 0,
    kv_length the prompt) through its table row; with `plain` the fp32
    plain version on q's fp32 image, 8 q heads at a time."""
    qz, pa = ops["quantized"], ops["paged_attention"]
    quant = s.kind != "bfloat16"
    q = s.admit[row][0]
    off, kvl = v4x_ints(torch, [0], [s.prompts[row]])
    table = s.table[row:row + 1]
    if not plain:
        fn = qz.paged_attention_extend_quantized if quant else pa.paged_attention_extend
        return fn(q, s.k, s.v, off, kvl, table)
    fn = qz.paged_attention_extend_quantized_plain if quant else pa.paged_attention_extend_plain
    return torch.cat([fn(q[:, h:h + 8].float(), s.k, s.v, off, kvl, table)
                      for h in range(0, q.shape[1], 8)], 1)


def v4d_path(torch, ops, paged_cache, s):
    """Drive stream s: each row's admission (pools), then the steps, each
    decoding plainly and with the stream's variant. Returns the outputs:
    {"admit": [per row], "steps": [(plain, variant) per step]}."""
    out = {"admit": [], "steps": []}
    none, = v4x_ints(torch, [0])
    for row, (_, nk, nv) in enumerate(s.admit):
        v4d_append(torch, ops, paged_cache, s, s.k, s.v, nk, nv, none, s.table[row:row + 1])
        out["admit"].append(v4d_extend(torch, ops, s, row))
    for q, nk, nv, lens in s.steps:
        v4d_append(torch, ops, paged_cache, s, s.k, s.v, nk, nv, lens, s.table)
        out["steps"].append((v4d_decode(torch, ops, s, q, lens + 1),
                             v4d_decode(torch, ops, s, q, lens + 1, **V4D_VARIANTS[s.ps])))
    return out


def v4d_expected(streams) -> dict:
    """The launches of path "v4-decode" over `streams`: each row's append
    and extend, each step's append and two decodes, each with D2."""
    want = {}
    for s in streams:
        append, extend, decode = s.kernels()
        for name, n in ((append, len(s.admit) + len(s.steps)), (extend, len(s.admit)),
                        (decode, 2 * len(s.steps)), ("decode_combine", 2 * len(s.steps))):
            if name is not None:
                want[name] = want.get(name, 0) + n
    return want


def v4d_check(torch, ops, paged_cache, errs, s, outs, what, tag=V4D_LABEL, pitch=None):
    """Stream s's outputs after its path: every admission and decode held by
    `held_rows`-style checks (BF16_TOL, ROW_TOL, finite, the plain shape)
    to its fp32 plain version and to a second call now (the pools hold the
    later steps' rows past each call's lengths, which must not reach it:
    the repeat is bit for bit); the appends (or QA) replayed by their plain
    versions on the copies give the same pools bit for bit. Errors noted
    under `tag`; one line per kernel. Returns {kernel: (max |diff|, max
    row_err)}."""
    append, extend, decode = s.kernels()
    worst = {}

    def hold(key, got, ref, again, where, pitched_out=False):
        e, r = max_err(got, ref), row_err(got, ref)
        check(got.shape == ref.shape, f"{what} {where}: the plain shape")
        check(bool(torch.isfinite(got).all()), f"{what} {where}: finite")
        check(e <= BF16_TOL, f"{what} {where} within {BF16_TOL} ({e:.3e})")
        check(r <= ROW_TOL, f"{what} {where}: row_err within {ROW_TOL} ({r:.3e})")
        check(torch.equal(got, again), f"{what} {where}: a second call repeats bit for bit")
        if pitched_out and pitch is not None:  # the extends' outputs lie at the pitch
            check(got.stride(-2) == pitch, f"{what} {where}: rows at the pitch {pitch}")
        note_err(errs, key, e, tag)
        note_err(errs, f"{key} row_err", r, tag)
        we, wr = worst.get(key, (0.0, 0.0))
        worst[key] = (max(we, e), max(wr, r))

    for row, got in enumerate(outs["admit"]):
        hold(extend, got, v4d_extend(torch, ops, s, row, plain=True),
             v4d_extend(torch, ops, s, row), f"admission of row {row} ({s.prompts[row]} tokens)",
             True)
    for t, (q, _, _, lens) in enumerate(s.steps):
        for got, kw in zip(outs["steps"][t], ({}, V4D_VARIANTS[s.ps])):
            hold(decode, got, v4d_decode(torch, ops, s, q, lens + 1, plain=True, **kw),
                 v4d_decode(torch, ops, s, q, lens + 1, **kw), f"step {t} {kw or ''}")
    if append is not None:
        none, = v4x_ints(torch, [0])
        for row, (_, nk, nv) in enumerate(s.admit):
            v4d_append(torch, ops, paged_cache, s, s.k0, s.v0, nk, nv, none,
                       s.table[row:row + 1], plain=True)
        for _, nk, nv, lens in s.steps:
            v4d_append(torch, ops, paged_cache, s, s.k0, s.v0, nk, nv, lens, s.table, plain=True)
        pairs = ((s.k, s.k0), (s.v, s.v0)) if s.kind == "bfloat16" else (
            (s.k.values, s.k0.values), (s.k.scales, s.k0.scales), (s.v.values, s.v0.values),
            (s.v.scales, s.v0.scales))
        same = all(torch.equal(raw_bits(torch, a), raw_bits(torch, b)) for a, b in pairs)
        check(same, f"{what}: {append} writes the pools its plain version writes, bit for bit")
        note_err(errs, append, 0.0, tag)
        worst[append] = "bit-identical"
    print(f"  {what}: " + "; ".join(
        f"{k} " + (v if isinstance(v, str) else f"max|diff| {v[0]:.3e}, row_err {v[1]:.3e}")
        for k, v in worst.items()) + ", every call repeated bit for bit")
    return worst


def v4d_streams(torch, qz, gen, d, prompts, steps, contig_lengths, capacity, cache, page_sizes):
    """The streams of one head dim: each kind over each page size, then
    over a contiguous cache."""
    streams = [v4d_stream(torch, qz, gen, kind, ps, d, prompts, steps, capacity)
               for kind in V4D_KINDS for ps in page_sizes]
    streams += [v4d_stream(torch, qz, gen, kind, "contiguous", d, contig_lengths, steps, cache)
                for kind in V4D_KINDS]
    return streams


def phase_v4_decode(torch, ops, paged_cache, kernels, path_counts, errs):
    """Phase 5n's checks and path (the constants above): path "v4-decode"
    counted exactly (`v4d_expected`: the append 72, B6 8, B5 128, QA 208,
    B9 16, B8 256, D1 64, B7 128, D2 576; nothing else), then every output
    held by `v4d_check`, D2 alone on D1's partials of the last step held to
    its plain version and repeated bit for bit; then d 260 and 320 alike at
    the small size, each kernel launched there. Returns the D 512 streams
    (their pools as the path left them) for the numbers."""
    from flash_attention_cute_tpu_torch.ops import _build

    qz, fd = ops["quantized"], ops["flash_decode"]
    gen = torch.Generator(device="cuda").manual_seed(4400)
    d = V4_D
    streams = v4d_streams(torch, qz, gen, d, V4D_PROMPTS, V4D_STEPS, V4D_CONTIG_LENGTHS,
                          V4X_PAGED_CAP + V4D_STEPS, V4D_CACHE, V4D_PAGE_SIZES)
    outs, wall, counts = counted_run(torch, kernels, lambda: [
        v4d_path(torch, ops, paged_cache, s) for s in streams])
    add_counts(path_counts.setdefault(V4D_LABEL, {}), counts)
    want = v4d_expected(streams)
    print(f"  path {V4D_LABEL!r}: {len(V4D_PROMPTS)} rows admitting {V4D_PROMPTS} tokens over "
          f"pages of {V4D_PAGE_SIZES}, then {V4D_STEPS} decode steps (plain, and window "
          f"{V4_WINDOW} / cap {V4_CAP:g}), over bf16, int8 and e4m3 pools and contiguous "
          f"caches of {V4D_CACHE} from {V4D_CONTIG_LENGTHS}, {V4_HQ} / {V4_HKV} heads, D {d}: "
          f"{wall * 1e3:.1f} ms (host clock), launches "
          f"{ {name: c for name, c in counts.items() if c} }")
    check_launched(counts, want, f"path {V4D_LABEL}")
    for s, out in zip(streams, outs):
        v4d_check(torch, ops, paged_cache, errs, s, out, f"{V4D_LABEL} {s.kind} "
                  f"{s.ps if s.ps == 'contiguous' else f'pages of {s.ps}'} D {d}")
    del outs
    s = next(x for x in streams if x.kind == "bfloat16" and x.ps == "contiguous")
    q, _, _, lens = s.steps[-1]
    splits = ops["dispatch"].decode_num_splits(len(lens), V4_HKV, V4D_CACHE, d, V4_HQ)
    acc, m, l = fd.decode_partials(q, s.k[0], s.v[0], lens + 1, d ** -0.5, splits)
    got = fd.decode_combine(acc, m, l, torch.bfloat16)
    held_rows(torch, errs, f"{V4D_LABEL} D2 alone on D1's partials ({splits} splits) D {d}",
              "decode_combine", V4D_LABEL, got, fd.decode_combine_plain(acc, m, l, torch.float32),
              fd.decode_combine(acc, m, l, torch.bfloat16))
    del acc, m, l, got
    torch.cuda.empty_cache()
    for dd in (260, 320):
        small = v4d_streams(torch, qz, gen, dd, V4D_SMALL_PROMPTS, V4D_SMALL_STEPS,
                            [V4D_SMALL_CACHE - V4D_SMALL_STEPS, V4D_SMALL_CACHE // 2 + 3,
                             V4D_SMALL_CACHE // 8 + 1, 1],
                            max(V4D_SMALL_PROMPTS) + V4D_SMALL_STEPS, V4D_SMALL_CACHE, (16,))
        before = {name: k.launches for name, k in kernels.items()}
        for s in small:
            v4d_check(torch, ops, paged_cache, errs, s, v4d_path(torch, ops, paged_cache, s),
                      f"{s.kind} {s.ps if s.ps == 'contiguous' else f'pages of {s.ps}'} D {dd}",
                      f"{V4D_LABEL} d{dd}", _build.row_pitch(dd))
        ran = {name: k.launches - before[name] for name, k in kernels.items()}
        check(all(ran[name] > 0 for name in want), f"every kernel of path {V4D_LABEL} "
              f"launched at D {dd}: {ran}")
        del small
    torch.cuda.empty_cache()
    return streams


def v4d_rows(torch, ops, paged_cache, streams, path_counts, errs, reports):
    """Phase 5n's numbers: the "v4" entries of the D1, D2, B5, B7, B8, B9,
    append and QA rows at path "v4-decode"'s shapes, timed on the D 512
    streams as the path left them (every row `V4D_STEPS` tokens past its
    prompt, or past V4D_CONTIG_LENGTHS in a cache): a decode step of B 4
    (D1 alone, its "with_combine_ms" D1 + D2; B5, B7 and B8 with D2; B5 /
    B8 over pages of 16, "page64" over pages of 64, "window" with the window
    of 128; B7 / B8 over int8, "e4m3" over e4m3), D2 alone on D1's
    partials, one step's append (bf16 pages of 16) and QA (int8 pages of
    16), B9's admission of the 4096-token prompt (int8 pages of 16, "e4m3";
    "b6": B6's over bf16 pages of 16, the same shape).
    ms / call_ms as elsewhere, the fp32 plain version's ms, library_ms one
    SDPA call (`sdpa_entry`) over a contiguous, gathered or dequantized bf16
    copy (NaN past the lengths zeroed; the copy not timed) with the group
    expanded and the lengths (and window) as a mask, `index_copy_` for the
    append, null for D2 and QA; bounds by bytes: q and the output once, each
    visible K / V row once (one-byte rows with their f32 scales), the
    tables' entries; B9's by operations (4 d a visible pair and q head);
    the D 512 instantiation's runtime attributes, the path's launches and
    errors."""
    from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms

    qz, pa, fd = ops["quantized"], ops["paged_attention"], ops["flash_decode"]
    d1_report, b7_report, b5_report, b8_report, b9_report = reports
    d, hq, hkv = V4_D, V4_HQ, V4_HKV
    heads = f"Hq {hq}, Hkv {hkv}, D {d} (DeepSeek-V4-Flash's attention)"
    launches = path_counts[V4D_LABEL]

    def stream(kind, ps):
        return next(s for s in streams if s.kind == kind and s.ps == ps)

    def extra(name, label):
        return {"launches": launches[name], "max_abs_err": errs[f"{name} {V4D_LABEL}"],
                **({"max_row_err": errs[f"{name} row_err {V4D_LABEL}"]}
                   if f"{name} row_err {V4D_LABEL}" in errs else {}),
                "runtime_attributes": runtime_attributes(reports_of[name], label)}

    reports_of = {"decode_partials": d1_report, "quant_decode": b7_report,
                  "paged_decode": b5_report, "quant_paged_decode": b8_report,
                  "quant_paged_extend": b9_report}

    def decode_entry(s, kw=None, name=None):
        """One decode step of stream s over every row's keys so far."""
        kw = kw or {}
        q, _, _, lens = s.steps[-1]
        lens = lens + 1
        lengths = lens.tolist()
        window = kw.get("window")
        live = sum(min(n, window) if window else n for n in lengths)
        elem = 2 if s.kind == "bfloat16" else 1
        kv_bytes = 2 * hkv * live * (d * elem + (0 if elem == 2 else 4))
        cap_len = s.k.shape[3] if s.ps == "contiguous" and elem == 2 else (
            s.k.values.shape[3] if s.ps == "contiguous" else s.table.shape[1] * s.ps)
        tables = 0 if s.ps == "contiguous" else 4 * sum(-(-n // s.ps) for n in lengths)
        nbytes = 2 * 2 * q.numel() + kv_bytes + tables + 4 * len(lengths)
        if s.ps == "contiguous" and elem == 2:
            splits = ops["dispatch"].decode_num_splits(len(lengths), hkv, cap_len, d, hq)
            fn = lambda: fd.decode_partials(q, s.k[0], s.v[0], lens, d ** -0.5, splits, **kw)
            plain = lambda: fd.decode_partials_plain(q.float(), s.k[0], s.v[0], lens, d ** -0.5,
                                                     splits, **kw)
        else:
            fn = lambda: v4d_decode(torch, ops, s, q, lens, **kw)
            plain = lambda: v4d_decode(torch, ops, s, q, lens, plain=True, **kw)
        if s.ps == "contiguous":
            kc, vc = ((s.k[0], s.v[0]) if elem == 2 else
                      (qz.dequantize_kv(qz.QuantizedKV(x.values[0], x.scales[0]), torch.bfloat16)
                       for x in (s.k, s.v)))
        elif elem == 2:
            kc, vc = (pa.gather_pages(x, s.table) for x in (s.k, s.v))
        else:
            kc, vc = (qz._gather_dequantized(x, s.table).to(torch.bfloat16) for x in (s.k, s.v))
        kc, vc = kc.nan_to_num(), vc.nan_to_num()
        pos = torch.arange(kc.shape[2], device="cuda")[None, :]
        mask = pos < lens[:, None]
        if window:
            mask &= pos >= lens[:, None] - window
        where = (f"page_size {s.ps}" if s.ps != "contiguous" else f"a contiguous cache of "
                 f"{cap_len}")
        e = {"shape": f"B {len(lengths)}, lengths {lengths}, {where}, {s.kind}"
                      + "".join(f", {k} {v:g}" for k, v in kw.items()) + f", {heads}; "
                      + ("ms D1 alone" if s.ps == "contiguous" and elem == 2 else
                         "ms includes D2"),
             **timed_v4(fn, plain, 50), **bound(4 * hq * live * d, nbytes, PEAK_BF16),
             **sdpa_entry(torch, q, kc, vc, attn_mask=mask[:, None, None, :])}
        if s.ps == "contiguous" and elem == 2:
            e.update(library_of=LIBRARY_OF_D1, with_combine_ms=cuda_time_ms(
                lambda: v4d_decode(torch, ops, s, q, lens, **kw), 50))
        del kc, vc, mask
        torch.cuda.empty_cache()
        return e

    out = {}
    s = stream("bfloat16", "contiguous")
    out["decode_partials"] = {**decode_entry(s), "window": decode_entry(
        s, V4D_VARIANTS["contiguous"]), **extra("decode_partials", "D1 bf16 D512")}
    q, _, _, lens = s.steps[-1]
    splits = ops["dispatch"].decode_num_splits(len(lens), hkv, V4D_CACHE, d, hq)
    acc, m, l = fd.decode_partials(q, s.k[0], s.v[0], lens + 1, d ** -0.5, splits)
    part_bytes = 4 * (acc.numel() + 2 * m.numel())
    out["decode_combine"] = {
        "shape": f"D1's partials of the step above: B 4, {splits} splits, {heads}",
        **timed_v4(lambda: fd.decode_combine(acc, m, l, torch.bfloat16),
                   lambda: fd.decode_combine_plain(acc, m, l, torch.bfloat16), 50),
        **bound(4 * acc.numel(), part_bytes + 2 * q.numel(), PEAK_F32), "library_ms": None,
        "library": "null: no PyTorch call merges split partials",
        "launches": launches["decode_combine"],
        "max_abs_err": errs[f"decode_combine {V4D_LABEL}"]}
    del acc, m, l
    out["quant_decode"] = {**decode_entry(stream("int8", "contiguous")),
                           "e4m3": decode_entry(stream("float8_e4m3fn", "contiguous")),
                           **extra("quant_decode", "B7 bf16 int8 D512")}
    s16, s64 = stream("bfloat16", 16), stream("bfloat16", 64)
    out["paged_decode"] = {**decode_entry(s16), "page64": decode_entry(s64),
                           "window": decode_entry(s16, V4D_VARIANTS[16]),
                           **extra("paged_decode", "B5 bf16 D512")}
    out["quant_paged_decode"] = {**decode_entry(stream("int8", 16)),
                                 "page64": decode_entry(stream("int8", 64)),
                                 "e4m3": decode_entry(stream("float8_e4m3fn", 16)),
                                 **extra("quant_paged_decode", "B8 bf16 int8 D512")}

    # One step's writes at the path's end (rows past their last step: the
    # pools' room is V4D_STEPS keys past the longest prompt + 32).
    q, nk, nv, lens = s16.steps[-1]
    b = len(V4D_PROMPTS)
    flat = pa.append_targets(s16.table, lens, 1, 16)[0].view(-1)
    kflat, vflat = (flat_pool(x) for x in (s16.k, s16.v))
    krows, vrows = (x.permute(1, 0, 2, 3).reshape(hkv, b, d) for x in (nk, nv))
    k0, v0 = s16.k.clone(), s16.v.clone()

    def library_append():
        kflat.index_copy_(1, flat, krows)
        vflat.index_copy_(1, flat, vrows)

    out["paged_append"] = {
        "shape": f"B {b}, S 1, page_size 16, bf16, {heads}; library_ms is index_copy_ on K and "
                 "on V",
        **timed_v4(lambda: paged_cache.paged_append_layer(s16.k, s16.v, nk, nv, s16.table, lens),
                   lambda: paged_cache.paged_append_layer_plain(k0, v0, nk, nv, s16.table, lens),
                   50),
        "library_ms": cuda_time_ms(library_append, 50),
        **bound(0, 2 * 2 * 2 * nk.numel() + 4 * 2 * b, PEAK_F32),
        "launches": launches["paged_append"], "max_abs_err": errs[f"paged_append {V4D_LABEL}"]}
    del k0, v0
    s8 = stream("int8", 16)
    q, nk, nv, lens = s8.steps[-1]
    c8 = [qz.QuantizedKV(x.values.clone(), x.scales.clone()) for x in (s8.k, s8.v)]
    out["quant_append"] = {
        "shape": f"B {b}, S 1, page_size 16, int8, {heads}; library_ms: null (no single call "
                 "quantizes)",
        **timed_v4(lambda: qz.quantize_append(nk, nv, s8.k, s8.v, lens, s8.table),
                   lambda: qz.quantize_append_plain(nk, nv, *c8, lens, s8.table), 50),
        "library_ms": None,
        **bound(0, 2 * 2 * nk.numel() + 2 * (nk.numel() + 4 * b * hkv) + 4 * 2 * b, PEAK_F32),
        "launches": launches["quant_append"], "max_abs_err": errs[f"quant_append {V4D_LABEL}"]}
    del c8

    def admission_entry(s):
        """B9's (B6's over bf16 pages) admission of row 0's prompt (B 1,
        causal from 0)."""
        n = s.prompts[0]
        q = s.admit[0][0]
        quant = s.kind != "bfloat16"
        kd, vd = ((qz._gather_dequantized(x, s.table[:1]).to(torch.bfloat16) if quant
                   else pa.gather_pages(x, s.table[:1]))[:, :, :n] for x in (s.k, s.v))
        pairs = n * (n + 1) // 2
        e = {"shape": f"B 1, S {n}, q_offset 0, page_size {s.ps}, {s.kind}, {heads}",
             **timed_v4(lambda: v4d_extend(torch, ops, s, 0),
                        lambda: v4d_extend(torch, ops, s, 0, plain=True), 10),
             **bound(4 * d * hq * pairs, 2 * 2 * q.numel()
                     + 2 * hkv * (d + 4 if quant else 2 * d) * n + 4 * (2 + -(-n // s.ps)),
                     PEAK_BF16),
             **sdpa_entry(torch, q, kd, vd, is_causal=True)}
        del kd, vd
        torch.cuda.empty_cache()
        return e

    # "b6": B6 on the same admission over bf16 pages: B9's widening (and its
    # 56 / 224 register split) is the difference.
    out["quant_paged_extend"] = {**admission_entry(s8),
                                 "e4m3": admission_entry(stream("float8_e4m3fn", 16)),
                                 "b6": admission_entry(s16),
                                 **extra("quant_paged_extend", "B9 bf16 int8 D512")}
    return out


# Phase 5o: head dims from 257 to 512 in the attention backward B13a /
# B13b (csrc/flash_bwd.cu's layout of 512: B13a two blocks a 64-key block,
# 256 of dK's and dV's columns each, over q tiles of 32 rows; B13b 64 q
# rows over 16-key tiles, its consumers splitting the depth of S and dP),
# and so in training through the autograd op `ops.autodiff.flash_attention`
# (P or B2 with the lse forward, B13a / B13b backward), at
# DeepSeek-V4-Flash's attention widths (64 / 1 heads, D 512, bf16, its
# window of 128). JAX's API and model path refuse a head dim above 256, as
# the port's do, so the path is the kernel-level entry point: three AdamW
# steps over leaf q, k, v [1, 64 / 1, V4T_S, 512] against a fixed random
# target, causal and windowed, on path "v4-train". Gradients are held to
# the fp32 plain backward fed the kernel forward's o and lse, 8 q heads at
# a time (its [64, 4096, 4096] score matrices would take 4.3 GB each).
# Then d 260 (rows of 264) and 320 at a small size.
V4T_LABEL = "v4-train"
V4T_S, V4T_STEPS, V4T_LR = 4096, 3, 1e-3
V4T_SMALL_DIMS, V4T_SMALL_S, V4T_SMALL_HEADS = (260, 320), 256, (8, 1)


def v4t_inputs(torch, gen, d, s, hq, hkv):
    """Leaf bf16 q, k, v (at the port's row pitch) that record gradients,
    and a cotangent dO."""
    q, k, v = (v4_randn(torch, gen, 1, h, s, d).requires_grad_() for h in (hq, hkv, hkv))
    return q, k, v, v4_randn(torch, gen, 1, hq, s, d)


def v4t_plain_grads(torch, ops, q, k, v, do, window, step=8):
    """(dq, dk, dv) of the fp32 plain backward (`flash_attention_bwd_plain`)
    fed the kernel forward's o and lse, `step` q heads of one group at a
    time, dk and dv summed over the chunks in fp32."""
    flash_fwd, flash_bwd = ops["flash_fwd"], ops["flash_bwd"]
    q, k, v = q.detach(), k.detach(), v.detach()
    o, lse = flash_fwd.flash_attention_fwd(q, k, v, causal=True, window=window, return_lse=True)
    group = q.shape[1] // k.shape[1]
    step = min(step, group)
    check(group % step == 0, "the plain backward's chunks stay inside a group")
    dq = torch.empty(q.shape, device="cuda")
    dk, dv = torch.zeros(k.shape, device="cuda"), torch.zeros(v.shape, device="cuda")
    for h in range(0, q.shape[1], step):
        kv = slice(h // group, h // group + 1)
        a, b, c = flash_bwd.flash_attention_bwd_plain(
            q[:, h:h + step].float(), k[:, kv].float(), v[:, kv].float(), o[:, h:h + step],
            do[:, h:h + step], lse[:, h:h + step], causal=True, window=window)
        dq[:, h:h + step] = a
        dk[:, kv] += b
        dv[:, kv] += c
        del a, b, c
    del o, lse
    return dq, dk, dv


def held_grads(torch, ops, errs, rel_errs, what, window, q, k, v, do, tag):
    """Gradients through `ops.autodiff.flash_attention` (P or B2, then B13a
    and B13b, each launched once) within GRAD_REL_TOL of the fp32 plain
    backward (max |diff| over max |plain|, each gradient) and, row by row,
    within ROW_TOL (`row_err`; dq from row 1 on: row 0 sees one key, where
    dS = p (dP - delta) is 0 but for the fp32 rounding of either version),
    finite, and a second call bit for bit."""
    flash_bwd, autodiff = ops["flash_bwd"], ops["autodiff"]
    before = (flash_bwd.DKV.launches, flash_bwd.DQ.launches)
    got = torch.autograd.grad(autodiff.flash_attention(q, k, v, causal=True, window=window),
                              (q, k, v), do)
    again = torch.autograd.grad(autodiff.flash_attention(q, k, v, causal=True, window=window),
                                (q, k, v), do)
    torch.cuda.synchronize()
    check((flash_bwd.DKV.launches - before[0], flash_bwd.DQ.launches - before[1]) == (2, 2),
          f"{what}: B13a and B13b launched once a call")
    want = v4t_plain_grads(torch, ops, q, k, v, do, window)
    rel = [rel_err(a, w) for a, w in zip(got, want)]
    rows = [row_err(got[0][:, :, 1:], want[0][:, :, 1:])] + [
        row_err(a, w) for a, w in zip(got[1:], want[1:])]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, idx in (("flash_bwd_dq", (0,)), ("flash_bwd_dkv", (1, 2))):
        note_err(errs, name, max(max_err(got[i], want[i]) for i in idx), tag)
        note_err(rel_errs, name, max(rel[i] for i in idx), tag)
        note_err(errs, f"{name} row_err", max(rows[i] for i in idx), tag)
    print(f"  {what}: dq / dk / dv max|diff| / max|plain| " + " / ".join(f"{r:.2e}" for r in rel)
          + ", row_err " + " / ".join(f"{r:.2e}" for r in rows)
          + f"; repeated bit for bit: {same}")
    check(all(tuple(a.shape) == tuple(x.shape) and bool(torch.isfinite(a).all())
              for a, x in zip(got, (q, k, v))), f"{what}: gradients finite, of q / k / v's shapes")
    check(max(rel) <= GRAD_REL_TOL, f"{what}: gradients within {GRAD_REL_TOL} (relative)")
    check(max(rows) <= ROW_TOL, f"{what}: gradients within {ROW_TOL} row by row")
    check(same, f"{what}: a second call gives bit-identical dq / dk / dv")
    del got, again, want


def v4t_train(torch, ops, kernels, window, seed):
    """V4T_STEPS AdamW steps (lr V4T_LR) over leaf q, k, v at V4's widths
    through `ops.autodiff.flash_attention` against a fixed random target
    (mean squared error in fp32), every launch count set to 0 just before
    and read just after: (losses, wall s, counts)."""
    autodiff = ops["autodiff"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, target = v4t_inputs(torch, gen, V4_D, V4T_S, V4_HQ, V4_HKV)
    opt = torch.optim.AdamW([q, k, v], lr=V4T_LR)
    losses = []
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(V4T_STEPS):
        opt.zero_grad(set_to_none=True)
        out = autodiff.flash_attention(q, k, v, causal=True, window=window)
        loss = torch.nn.functional.mse_loss(out.float(), target.float())
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: kern.launches for name, kern in kernels.items()}
    check(all(bool(torch.isfinite(x).all()) for x in (q, k, v)), "v4-train: finite leaves")
    del q, k, v, target, opt, out, loss
    torch.cuda.empty_cache()
    return losses, wall, counts


def phase_v4_train(torch, ops, kernels, path_counts, errs, rel_errs):
    """Phase 5o's checks and path (the constants above): gradients at V4's
    widths, causal and with the window (`held_grads`), the three AdamW
    steps of each on path "v4-train" counted exactly (causal: P 3, B13a 3,
    B13b 3; windowed: B2 3, B13a 3, B13b 3; nothing else; B13a's combine
    pass, one C call with it, is not counted apart) with a loss that falls;
    d 260 and 320 at B 1 x V4T_SMALL_S, 8 / 1 heads; D 520 and D 0 refused
    by the backward and the autograd op before any launch."""
    flash_fwd, flash_bwd, autodiff = ops["flash_fwd"], ops["flash_bwd"], ops["autodiff"]
    gen = torch.Generator(device="cuda").manual_seed(4401)
    for window in (None, V4_WINDOW):
        what = f"{V4T_LABEL} gradients B 1 x S {V4T_S}, {V4_HQ} / {V4_HKV} heads, D {V4_D}, " + (
            f"window {window}" if window else "causal")
        q, k, v, do = v4t_inputs(torch, gen, V4_D, V4T_S, V4_HQ, V4_HKV)
        held_grads(torch, ops, errs, rel_errs, what, window, q, k, v, do, V4T_LABEL)
        del q, k, v, do
        torch.cuda.empty_cache()
    path_counts[V4T_LABEL] = {}
    for window, fwd, seed in ((None, "flash_fwd", 4402), (V4_WINDOW, "flash_fwd_window", 4403)):
        losses, wall, counts = v4t_train(torch, ops, kernels, window, seed)
        add_counts(path_counts[V4T_LABEL], counts)
        what = f"path {V4T_LABEL!r} " + (f"window {window}" if window else "causal")
        print(f"  {what}: {V4T_STEPS} AdamW steps (lr {V4T_LR}) over q, k, v [1, {V4_HQ} / "
              f"{V4_HKV}, {V4T_S}, {V4_D}]: {wall * 1e3:.1f} ms (host clock), losses "
              f"{[round(x, 6) for x in losses]}, launches "
              f"{ {name: c for name, c in counts.items() if c} }")
        check_launched(counts, {fwd: V4T_STEPS, "flash_bwd_dkv": V4T_STEPS,
                                "flash_bwd_dq": V4T_STEPS}, what)
        check(all(x == x for x in losses) and losses[-1] < losses[0],
              f"{what}: the loss falls from step 1 to step {V4T_STEPS}: {losses}")
    hq, hkv = V4T_SMALL_HEADS
    for d in V4T_SMALL_DIMS:
        q, k, v, do = v4t_inputs(torch, gen, d, V4T_SMALL_S, hq, hkv)
        held_grads(torch, ops, errs, rel_errs, f"gradients D {d} (rows of {q.stride(-2)}), B 1 x "
                   f"S {V4T_SMALL_S}, {hq} / {hkv} heads, causal", None, q, k, v, do, V4T_LABEL)
        del q, k, v, do
    counted = (flash_fwd.PREFILL, flash_fwd.WINDOWED_PREFILL, flash_bwd.DKV, flash_bwd.DQ)

    def refused(d, autograd):
        q = v4_randn(torch, gen, 1, 4, 64, d).requires_grad_()
        k = v4_randn(torch, gen, 1, 1, 64, d)
        if autograd:
            autodiff.flash_attention(q, k, k, sm_scale=1.0, causal=True).sum().backward()
        else:
            flash_bwd.flash_attention_bwd(q.detach(), k, k, q.detach(), q.detach(),
                                          torch.zeros(1, 4, 64, device="cuda"), sm_scale=1.0,
                                          causal=True)

    head_dims_refused(torch, ops, "B13a / B13b and the autograd op (the layout of 512)",
                      [lambda d: refused(d, False), lambda d: refused(d, True)], counted,
                      dims=(520, 0))
    torch.cuda.empty_cache()


def v4t_rows(torch, ops, gen, path_counts, errs, rel_errs, bwd_report):
    """Phase 5o's numbers: the "v4" entries of the B13a and B13b rows at
    path "v4-train"'s causal attention (B 1, S V4T_S, 64 / 1 heads, D 512;
    `bwd_timings`: each kernel launched alone, ms and call_ms; plain_ms the
    whole fp32 plain backward; library_ms SDPA's backward, fwd + bwd - fwd,
    or null with the reason SDPA raised; the operations bound, 8 D (B13a)
    and 6 D (B13b) a visible pair and q head at the bf16 rate: B13a's
    recompute of S^T and dP^T in each of its two column blocks is not
    counted), the D 512 instantiation's runtime attributes, the path's
    launches and the phase's errors."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = bwd_timings(torch, ops, randn, 1, V4_HQ, V4_HKV, V4T_S, V4_D)
    for name, entry in out.items():
        label = "B13a" if name == "flash_bwd_dkv" else "B13b"
        entry.update(
            shape=f"B 1, S {V4T_S}, causal, Hq {V4_HQ}, Hkv {V4_HKV}, D {V4_D} "
                  f"(DeepSeek-V4-Flash's attention); plain_ms: the whole plain backward",
            launches=path_counts[V4T_LABEL][name],
            max_abs_err=errs[f"{name} {V4T_LABEL}"], max_rel_err=rel_errs[f"{name} {V4T_LABEL}"],
            max_row_err=errs[f"{name} row_err {V4T_LABEL}"],
            runtime_attributes=runtime_attributes(bwd_report, f"{label} D512 bf16"),
            padded_runtime_attributes=runtime_attributes(bwd_report, f"{label} D512 padded bf16"))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=0,
                        help="cut every model's depth to this many layers (0 = full)")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "flash_attention_cute_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an NVIDIA Hopper card", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability()
    check(cap == (9, 0), f"compute capability 9.0 (Hopper), got {cap}")
    card = nvidia_smi()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from flash_attention_cute_tpu_torch.ops import (
        _build,
        autodiff,
        flash_bwd,
        flash_chunked,
        flash_decode,
        flash_fwd,
        flash_varlen,
        paged_attention,
        quantized,
        quantized_matmul,
    )
    from flash_attention_cute_tpu_torch.runtime import native, paged_cache

    t0 = time.perf_counter()
    reports = _build.build(["flash_fwd.cu", "flash_decode.cu", "flash_chunked.cu",
                            "paged_attention.cu", "quantized.cu", "quant_paged_decode.cu",
                            "quant_paged_extend.cu", "quantized_matmul.cu", "flash_bwd.cu",
                            "flash_varlen.cu"])
    t_nvcc = time.perf_counter() - t0
    native.build()
    print(f"[2] build: nvcc {t_nvcc:.1f} s, then g++ (native scheduler) "
          f"{time.perf_counter() - t0 - t_nvcc:.1f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    print("  B10 / B11, P / B2, B4, D1, B7, B5, B6, B8, B9, B12 and B13a / B13b instantiations "
          "(the runtime's "
          "attributes, launch shared memory; the consumers of P / B2, B4, B6, B12 and B13a / "
          "B13b raise theirs to 240 by setmaxnreg, B9's to 232, at D 512 to 224):")
    fwd_report, bwd_report = flash_fwd.kernel_report(), flash_bwd.kernel_report()
    b6_report, b9_report = paged_attention.kernel_report(), quantized.extend_kernel_report()
    b4_report, b12_report = flash_chunked.kernel_report(), flash_varlen.kernel_report()
    b5_report, b8_report = paged_attention.decode_kernel_report(), quantized.decode_kernel_report()
    d1_report, b7_report = flash_decode.kernel_report(), quantized.contiguous_decode_kernel_report()
    for line in (quantized_matmul.kernel_report().splitlines() + fwd_report.splitlines()
                 + b4_report.splitlines() + d1_report.splitlines() + b7_report.splitlines()
                 + b5_report.splitlines() + b6_report.splitlines()
                 + b8_report.splitlines() + b9_report.splitlines()
                 + b12_report.splitlines() + bwd_report.splitlines()):
        print(f"    {line}")
        spill = re.search(r"(\d+) bytes local", line)
        check(spill is not None and int(spill.group(1)) == 0, f"no spill in {line}")

    # 3. kernels vs plain
    kernels = {"flash_fwd": flash_fwd.PREFILL, "flash_fwd_window": flash_fwd.WINDOWED_PREFILL,
               "flash_fwd_int8": flash_fwd.PREFILL_INT8,
               "flash_fwd_window_int8": flash_fwd.WINDOWED_PREFILL_INT8,
               "quantize_k_rows": flash_fwd.QUANTIZE_K,
               "decode_partials": flash_decode.PARTIALS,
               "decode_combine": flash_decode.COMBINE, "flash_chunked": flash_chunked.CHUNKED,
               "flash_chunked_partials": flash_chunked.PARTIALS,
               "paged_decode": paged_attention.PAGED_DECODE,
               "paged_extend": paged_attention.PAGED_EXTEND, "paged_append": paged_cache.APPEND,
               "quant_decode": quantized.QUANT_DECODE,
               "quant_paged_decode": quantized.QUANT_PAGED_DECODE,
               "quant_paged_extend": quantized.QUANT_PAGED_EXTEND,
               "quant_append": quantized.QUANT_APPEND,
               "quantized_matmul": quantized_matmul.QMM8,
               "quantized_matmul_int4": quantized_matmul.QMM4,
               "flash_bwd_dkv": flash_bwd.DKV, "flash_bwd_dq": flash_bwd.DQ,
               "flash_varlen": flash_varlen.VARLEN}
    path_counts: dict = {"int8 scores": {}, "greedy": {}, "greedy int8": {}}
    errs: dict = {}
    print("[3] kernels vs plain (bf16, Hq 32 Hkv 8 D 128)")
    phase_kernels(torch, flash_fwd, flash_decode, errs)
    phase_paged_kernels(torch, paged_attention, paged_cache, errs)
    print("[3b] quantized kernels vs plain (bf16 q, int8 / e4m3 K/V, f32 scales)")
    phase_quant_kernels(torch, quantized, errs)
    print("[3c] quantized-weight products vs plain (bf16 x, int8 / int4 weights)")
    phase_qmm_kernels(torch, quantized_matmul, errs)
    print("[3d] contiguous extend B4 vs plain (bf16 / f16, NaN past every kv_length)")
    phase_chunked_kernels(torch, flash_chunked, errs)
    from flash_attention_cute_tpu_torch import dispatch

    ops = {"flash_fwd": flash_fwd, "flash_decode": flash_decode, "flash_chunked": flash_chunked,
           "paged_attention": paged_attention, "quantized": quantized, "dispatch": dispatch}
    print("[3e] sliding windows: B2, and D1, B4, B5-B9 windowed, vs plain (NaN tails)")
    phase_window_kernels(torch, ops, errs)
    ops.update(flash_bwd=flash_bwd, flash_varlen=flash_varlen, autodiff=autodiff)
    rel_errs: dict = {}
    print("[3f] training kernels: the lse of P / B2, B13a (dK, dV) and B13b (dQ) vs plain")
    t0 = time.perf_counter()
    phase_training_kernels(torch, ops, errs, rel_errs)
    print(f"  phase 3f: {time.perf_counter() - t0:.1f} s")
    print("[3g] packed ragged batch: B12 vs plain (per-sequence dense attention)")
    phase_varlen_kernels(torch, flash_varlen, errs)
    print("[3h] Gemma2: soft caps 50 and 1.0 at D 256 (Hq 16, Hkv 8) in P / B2, D1 + D2, B5, "
          "B6, B8, B9, the append and QA at D 256, and the caps at D 128 (B5 / B8 also at a "
          "group of 32), vs plain")
    phase_gemma2_kernels(torch, ops, errs)
    print("[3i] int8 scores: K8, P-i8 / B2-i8 vs plain at Llama-3-8B, Mistral-7B and Gemma-2-9B "
          "widths, then the API's int8-score route")
    t0 = time.perf_counter()
    phase_int8_kernels(torch, flash_fwd, errs)
    from flash_attention_cute_tpu_torch import api

    phase_int8_path(torch, api, flash_fwd, kernels, path_counts["int8 scores"])
    torch.cuda.synchronize()
    print(f"  phase 3i: {time.perf_counter() - t0:.1f} s")
    print("[3j] head dims outside 64 / 128 / 256: P / B2, D1 + D2, B5, B6 and the append at D "
          "96, 80, 32, 160 (f16) and 192 vs plain, D 96 also windowed and capped")
    t0 = time.perf_counter()
    phase_odd_head_dims(torch, ops, paged_cache, errs)
    torch.cuda.synchronize()
    print(f"  phase 3j: {time.perf_counter() - t0:.1f} s")
    print("[3k] head dims outside 64 / 128 / 256 over int8 / e4m3 caches and in the extend: "
          "B7 + D2, B8 + D2, B9, QA and B4 at D 96, 80, 32, 160 (f16) and 192 vs plain, D 96 "
          "also windowed and capped; D 40 over one-byte rows and D 100 in B4, refused before "
          "the pitched rows, launched; B7, B8, B9, QA, B4 and its partials launched at D 264, "
          "D 520 and D 0 refused")
    t0 = time.perf_counter()
    phase_odd_head_dims_quantized(torch, ops, errs)
    torch.cuda.synchronize()
    print(f"  phase 3k: {time.perf_counter() - t0:.1f} s")
    print("[3l] head dims outside 64 / 128 / 256 in training and packed batches: B13a / B13b "
          "(B13a also in 3 parts and in one) and B12 at D 8, 24, 40, 96, 136, 200 and 248 vs "
          "plain; D 100 (refused before the pitched rows) launched; D 520 and D 0 refused")
    t0 = time.perf_counter()
    phase_odd_head_dims_training(torch, ops, errs, rel_errs)
    torch.cuda.synchronize()
    print(f"  phase 3l: {time.perf_counter() - t0:.1f} s")
    print("[3m] GQA groups above 32 in D1 + D2, B5 + D2, B7 + D2 and B8 + D2 (groups 33, 48, "
          "64, 71, 128: chunks of at most 32 q rows a block) and above 8 in B6 / B9 (groups 12, "
          "16, 71) vs plain; then the API's decode at Falcon-7B's 71 / 1 heads (path "
          f"{MQA71_LABEL!r})")
    t0 = time.perf_counter()
    phase_large_groups(torch, ops, errs)
    path_counts[MQA71_LABEL] = {}
    phase_mqa71_path(torch, api, flash_decode, kernels, path_counts[MQA71_LABEL])
    torch.cuda.synchronize()
    print(f"  phase 3m: {time.perf_counter() - t0:.1f} s")
    print("[3n] B4's (o, m, l) partials vs plain at ring attention's step geometries (offsets "
          "S_local / 0 / -S_local, the zig-zag's halves, D 96 and 256, a group of 16, a window "
          "and caps, a kv_length-0 row, two-part P in f16, non-causal)")
    t0 = time.perf_counter()
    phase_partials_kernels(torch, flash_chunked, errs)
    torch.cuda.synchronize()
    print(f"  phase 3n: {time.perf_counter() - t0:.1f} s")
    print("[3o] every head dim from 1 to 256, rows at the port's pitch: K8 and P-i8 / B2-i8 at "
          "D 4, 40, 96 and 100; P / B2, D1 + D2, B5, B6, the append and B4 at D 4, 36 and 100 "
          "(32 / 8 heads; D 100 also windowed and capped); B7, B8, B9, QA and B4 at D 24, 40 "
          "and 72 over int8 / e4m3; B13a / B13b and B12 at D 36 and 100; P-i8 (K8): D 264 and "
          "D 0 refused; P / B2, B6, D1, B5 and the append: D 520 and D 0 refused, B6, D1, B5 "
          f"and the append launched at D 264; then the API's int8 scores at Phi-3-mini's widths (path "
          f"{PHI3_INT8_LABEL!r})")
    t0 = time.perf_counter()
    phase_pitched_head_dims(torch, ops, paged_cache, errs, rel_errs)
    path_counts[PHI3_INT8_LABEL] = {}
    phase_int8_phi3_path(torch, api, flash_fwd, kernels, path_counts[PHI3_INT8_LABEL], errs)
    torch.cuda.synchronize()
    print(f"  phase 3o: {time.perf_counter() - t0:.1f} s")

    # 4. main paths
    from flash_attention_cute_tpu_torch.models.llama import llama3_8b_config
    from flash_attention_cute_tpu_torch.models.transformer import init_params
    import dataclasses

    cfg = llama3_8b_config()
    if args.layers:
        print(f"  depth cut: {cfg.num_layers} -> {args.layers} layers (widths unchanged)")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[4] main paths: Llama-3-8B widths, {cfg.num_layers} layers, random weights "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    torch.cuda.reset_peak_memory_stats()
    ids, bf16_tokens, greedy_wall = phase_main_path(torch, cfg, params, kernels,
                                                    path_counts["greedy"])
    print("[4a] greedy generation over an int8 KV cache")
    int8_numbers = phase_main_path_int8(torch, cfg, params, ids, bf16_tokens, kernels,
                                        path_counts["greedy int8"])
    print("[4d] greedy generation with quantized weights: int8, and fused int4 over an "
          "int8 cache")
    weight_numbers = phase_quant_weights(torch, cfg, params, ids, bf16_tokens, kernels,
                                         path_counts)
    print("[4b] serving engine: 24 requests, runs A-G")
    serving = phase_serving(torch, cfg, params, kernels, path_counts)
    print("[4c] serving forward: kernel route vs plain_attention route (bf16, int8, e4m3 pools)")
    phase_serving_forward(torch, cfg, params, kernels)
    print("[4e] extend mode and speculative generation (B4)")
    phase_extend_logits(torch, cfg, params, ids, bf16_tokens, kernels)
    speculative = phase_speculative(torch, cfg, params, ids, kernels, path_counts, greedy_wall)
    print("[4k] the HF surface: HF state-dict conversion, attention_forward on a stand-in "
          "module, the patched HF model")
    path_counts["hf"] = {}
    t0 = time.perf_counter()
    hf_numbers = phase_hf(torch, cfg, params, ids, bf16_tokens, kernels, path_counts)
    hf_numbers["phase_s"] = time.perf_counter() - t0
    print(f"  phase 4k: {hf_numbers['phase_s']:.1f} s")

    # 5. numbers of the Llama paths, then its tree is dropped.
    print("[5] numbers (CUDA events for kernels, host clock + synchronise for phases)")
    rows, numbers, profile = phase_numbers(torch, cfg, params, ids, flash_fwd, flash_decode)
    numbers.update(int8_numbers)
    numbers.update(weight_numbers)
    del params
    torch.cuda.empty_cache()

    # 4f / 4g. Mistral-7B and Qwen2-7B, one tree at a time.
    from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_9b_config
    from flash_attention_cute_tpu_torch.models.mistral import mistral_7b_config
    from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_7b_config

    families = {}
    for step, name, make, phase, seed in (("4f", "Mistral-7B", mistral_7b_config, phase_mistral, 1),
                                          ("4g", "Qwen2-7B", qwen2_7b_config, phase_qwen2, 2),
                                          ("4j", "Gemma-2-9B", gemma2_9b_config, phase_gemma2, 3),
                                          ("4m", "Phi-3-mini widths", phi3_mini_widths_config,
                                           phase_phi3, 10),
                                          ("4p", "Llama-3.1-405B widths",
                                           llama31_405b_widths_config, phase_405b, 11)):
        fcfg = make()
        if args.layers:
            fcfg = dataclasses.replace(fcfg, num_layers=args.layers)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        fparams = init_params(fcfg, generator=torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        windows = fcfg.layer_window_pattern or (
            fcfg.sliding_window if fcfg.use_sliding_window else None)
        print(f"[{step}] {name}: hidden {fcfg.hidden_size}, {fcfg.num_q_heads} / "
              f"{fcfg.num_kv_heads} heads, head dim {fcfg.head_dim}, {fcfg.num_layers} layers, "
              f"window {windows}, QKV bias {fcfg.attention_bias}, soft caps "
              f"{fcfg.logit_softcap} / {fcfg.final_logit_softcap}, random weights "
              f"({time.perf_counter() - t0:.1f} s to draw)")
        families[name] = phase(torch, fcfg, fparams, kernels, path_counts)
        families[name]["weights_gb"] = tree_bytes(fparams) / 1e9
        families[name]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        families[name]["phase_s"] = time.perf_counter() - t0
        print(f"  phase {step}: {families[name]['phase_s']:.1f} s")
        del fparams
        torch.cuda.empty_cache()

    # 4h / 4i. Training steps of Llama-3-8B, then the varlen entry point.
    tcfg = dataclasses.replace(llama3_8b_config(), num_layers=min(
        TRAIN_LAYERS, args.layers or TRAIN_LAYERS))
    print(f"[4h] training: Llama-3-8B widths, depth cut {llama3_8b_config().num_layers} -> "
          f"{tcfg.num_layers} layers (AdamW over 32 bf16 layers needs weights + grads + two "
          f"states, about 64 GB, before activations), B {TRAIN_B} x S {TRAIN_S}, "
          f"{TRAIN_STEPS} AdamW steps")
    training = phase_training(torch, tcfg, kernels, path_counts)
    print("[4i] varlen: the cu_seqlens entry point over the packed batch of 3g")
    phase_varlen_path(torch, kernels, path_counts)
    gcfg, why = gemma2_training_config(args.layers)
    print(f"[4l] training: Gemma-2-9B widths with the attention cap off (hidden "
          f"{gcfg.hidden_size}, {gcfg.num_q_heads} / {gcfg.num_kv_heads} heads, D "
          f"{gcfg.head_dim}, window {gcfg.layer_window_pattern}, final cap "
          f"{gcfg.final_logit_softcap}), depth cut {gemma2_9b_config().num_layers} -> "
          f"{gcfg.num_layers} layers: {why}; B {GEMMA2_TRAIN_B} x S {GEMMA2_TRAIN_S}, "
          f"{TRAIN_STEPS} AdamW steps")
    t0 = time.perf_counter()
    training_gemma2 = phase_training(torch, gcfg, kernels, path_counts, GEMMA2_TRAIN_B,
                                     GEMMA2_TRAIN_S, GEMMA2_TRAIN_PATH, seed=4)
    training_gemma2["phase_s"] = time.perf_counter() - t0
    print(f"  phase 4l: {training_gemma2['phase_s']:.1f} s")
    print(f"[4o] training at Phi-3-mini's widths (hidden 3072, 32 / 32 heads, D 96 in D 128's "
          f"layout), B {TRAIN_B} x S {PHI3_TRAIN_S}, {TRAIN_STEPS} AdamW steps; then a packed "
          f"batch at D 96 (B12)")
    t0 = time.perf_counter()
    training_phi3 = phase_phi3_training(torch, ops, args.layers, kernels, path_counts, errs)
    training_phi3["phase_s"] = time.perf_counter() - t0
    print(f"  phase 4o: {training_phi3['phase_s']:.1f} s")
    print(f"[4q] sequence-parallel attention at Llama-3.1-8B's attention widths ({SP_HEADS[0]} / "
          f"{SP_HEADS[1]} heads, D {SP_D}): the ring over {SP_RANKS} ranks of "
          f"{SP_S // SP_RANKS} tokens (S {SP_S}) unrolled on one card, causal (zig-zag) and "
          f"non-causal, and the all-gather route (path {SP_LABEL!r}); S {SP_CHECK_S} over "
          f"{SP_CHECK_RANKS} ranks vs the fp32 plain reference; the entry points over a one-rank "
          f"NCCL mesh (path {SP_NCCL_LABEL!r})")
    t0 = time.perf_counter()
    sp_numbers = phase_sequence_parallel(torch, flash_fwd, kernels, path_counts, errs)
    sp_numbers["phase_s"] = time.perf_counter() - t0
    print(f"  phase 4q: {sp_numbers['phase_s']:.1f} s")
    print(f"[4r] shallow models at head dims outside TMA's stride rule (Llama-3-8B's widths, "
          f"32 / 8 heads, {pitched_model_config(100, args.layers).num_layers} layers): D 100 "
          f"over bf16 caches and pages (rows of 104), D 40 over int8 and e4m3 caches and pages "
          f"(rows of 48 bytes); greedy and serving runs A / B (D 100), D / E (D 40) over "
          f"{PITCHED_SERVING_REQUESTS} requests, no cache copied (paths {PITCHED_LABEL!r} ...)")
    t0 = time.perf_counter()
    pitched_models = phase_pitched_models(torch, kernels, path_counts, args.layers)
    pitched_models["phase_s"] = time.perf_counter() - t0
    print(f"  phase 4r: {pitched_models['phase_s']:.1f} s")

    for name in kernels:
        check(sum(c[name] for c in path_counts.values()) > 0,
              f"{name} launched on a main path")
    print("  D2 (decode_combine) launches by path: "
          + ", ".join(f"{p} {c['decode_combine']}" for p, c in path_counts.items())
          + " (after D1 over a bf16 cache, B7 over an int8 cache, B5 over bf16 pages, B8 "
          "over quantized pages)")

    print("[5b] numbers of the windowed kernels (Mistral-7B shapes, window 4096)")
    windowed = window_rows(torch, ops, torch.Generator(device="cuda").manual_seed(77))
    at = next(i for i, r in enumerate(rows) if r["name"] == "flash_fwd") + 1
    rows.insert(at, windowed.pop("flash_fwd_window"))
    for r in rows:
        if r["name"] in windowed:
            r["window"] = windowed[r["name"]]
    print("[5c] numbers of the training kernels (B 2, S 2048; B13a / B13b also at Gemma-2-9B's "
          "D 256, B 1, S 4608) and of B12 (the packed batch)")
    trows, lse_cost = training_rows(torch, ops, torch.Generator(device="cuda").manual_seed(78),
                                    path_counts)
    gemma_bwd = gemma2_training_rows(torch, ops, torch.Generator(device="cuda").manual_seed(81))
    for r in trows:
        if r["name"] in rel_errs:
            r["max_rel_err"] = rel_errs[r["name"]]
        if r["name"] in ("flash_bwd_dkv", "flash_bwd_dq"):
            label = "B13a" if r["name"] == "flash_bwd_dkv" else "B13b"
            r["runtime_attributes"] = runtime_attributes(bwd_report, f"{label} D128 bf16")
            r["gemma2"] = {**gemma_bwd[r["name"]],
                           "launches": path_counts[GEMMA2_TRAIN_PATH][r["name"]],
                           "max_abs_err": errs[f"{r['name']} d256"],
                           "max_rel_err": rel_errs[f"{r['name']} d256"],
                           "runtime_attributes": runtime_attributes(bwd_report,
                                                                    f"{label} D256 bf16")}
    rows += trows
    paged_reports = {"decode_partials": (d1_report, "D1 bf16 D128", "D1 bf16 D256 cap"),
                     "quant_decode": (b7_report, "B7 bf16 int8 D128", "B7 bf16 int8 D256 cap"),
                     "paged_decode": (b5_report, "B5 bf16 D128", "B5 bf16 D256 cap"),
                     "quant_paged_decode": (b8_report, "B8 bf16 int8 D128",
                                            "B8 bf16 int8 D256 cap"),
                     "paged_extend": (b6_report, "B6 bf16 D128", "B6 bf16 D256 cap"),
                     "quant_paged_extend": (b9_report, "B9 bf16 e4m3 D128",
                                            "B9 bf16 int8 D256 cap"),
                     "flash_chunked": (b4_report, "B4 D128 bf16 split-P", "B4 D256 bf16 cap"),
                     "flash_varlen": (b12_report, "B12 D128 bf16", "B12 D256 bf16 cap")}
    for r in rows:
        if r["name"] in ("flash_fwd", "flash_fwd_window"):
            r["lse"] = {"max_abs_err": errs[f"{r['name']} lse"], **lse_cost[r["name"]]}
            r["runtime_attributes"] = runtime_attributes(fwd_report, "P / B2 D128 bf16")
        if r["name"] in paged_reports:
            report, label, _ = paged_reports[r["name"]]
            r["runtime_attributes"] = runtime_attributes(report, label)
    print("[5d] numbers of the Gemma2 kernels (D 256, soft cap 50, Gemma-2-9B shapes)")
    gemma = gemma2_rows(torch, ops, torch.Generator(device="cuda").manual_seed(79))
    for r in rows:
        if r["name"] in gemma:
            r["gemma2"] = {"max_abs_err": errs[f"{r['name']} gemma2"], "launches": sum(
                c[r["name"]] for p, c in path_counts.items() if p.startswith("Gemma-2-9B")),
                **gemma[r["name"]]}
            if r["name"] in ("flash_fwd", "flash_fwd_window"):
                r["gemma2"].update(lse_max_abs_err=errs[f"{r['name']} gemma2 lse"],
                                   runtime_attributes=runtime_attributes(
                                       fwd_report, "P / B2 D256 bf16 cap"))
            if r["name"] in paged_reports:
                report, _, label = paged_reports[r["name"]]
                r["gemma2"]["runtime_attributes"] = runtime_attributes(report, label)
    print("[5e] numbers of the int8-score kernels (P-i8, B2-i8, K8)")
    i8_rows = int8_rows(torch, flash_fwd, torch.Generator(device="cuda").manual_seed(80))
    for r in i8_rows:
        if r["name"] != "quantize_k_rows":
            r["oracle_max_abs_err"] = errs[f"{r['name']} oracle"]
            r["lse"] = {"max_abs_err": errs[f"{r['name']} lse"]}
            r["runtime_attributes"] = runtime_attributes(fwd_report, "P-i8 / B2-i8 D128 bf16")
    r = next(r for r in i8_rows if r["name"] == "flash_fwd_int8")
    r["gemma2"]["runtime_attributes"] = runtime_attributes(fwd_report, "P-i8 / B2-i8 D256 bf16 cap")
    rows += i8_rows
    print("[5f / 5g] numbers of the kernels at Phi-3-mini's widths (D 96 in D 128's layout): "
          "P, D1, D2, B5, B6 and the append (5f); B7, B8, B9, QA and B4 (5g)")
    t0 = time.perf_counter()
    phi3 = phi3_rows(torch, ops, torch.Generator(device="cuda").manual_seed(82))
    for r in rows:
        if r["name"] in phi3:
            r["phi3"] = {"max_abs_err": errs[f"{r['name']} phi3"], "launches": sum(
                c[r["name"]] for p, c in path_counts.items() if p.startswith(PHI3_LABEL)),
                **phi3[r["name"]]}
    print(f"  phases 5f / 5g: {time.perf_counter() - t0:.1f} s")
    print("[5h] numbers of the training kernels at Phi-3-mini's widths (D 96 in D 128's layout): "
          "B13a / B13b at 4o's step, B12 at its packed batch")
    t0 = time.perf_counter()
    phi3_train = phi3_training_rows(torch, ops, torch.Generator(device="cuda").manual_seed(83))
    for r in rows:
        if r["name"] in phi3_train:
            label = {"flash_bwd_dkv": "B13a D128 padded bf16",
                     "flash_bwd_dq": "B13b D128 padded bf16",
                     "flash_varlen": "B12 D128 bf16"}[r["name"]]
            report = b12_report if r["name"] == "flash_varlen" else bwd_report
            r["phi3"] = {"max_abs_err": errs[f"{r['name']} phi3"], "launches": sum(
                c[r["name"]] for p, c in path_counts.items() if p.startswith(PHI3_LABEL)),
                **({"max_rel_err": rel_errs[f"{r['name']} phi3"]}
                   if f"{r['name']} phi3" in rel_errs else {}),
                "runtime_attributes": runtime_attributes(report, label),
                **phi3_train[r["name"]]}
    print(f"  phase 5h: {time.perf_counter() - t0:.1f} s")
    print("[5i] numbers at large GQA groups: the \"g16\" entries of the P, D1, D2, B5, B6, "
          "append, B7, B8, B9 and QA rows at phase 4p's shapes (Llama-3.1-405B's 128 / 8 heads); "
          "the \"m71\" entries of the D1, B5, B7 and B8 rows at Falcon-7B's 71 / 1 heads, D 64, "
          "B 8 x 2048 keys")
    t0 = time.perf_counter()
    g16 = llama405_rows(torch, ops, torch.Generator(device="cuda").manual_seed(84))
    m71 = mqa71_rows(torch, ops, torch.Generator(device="cuda").manual_seed(85))
    for r in rows:
        if r["name"] in g16:
            # max_abs_err at the group of 16 where phase 3m held the kernel there (B6 /
            # B9); the others are held at 4p's widths through the teacher-forced logits.
            r["g16"] = {"max_abs_err": errs.get(f"{r['name']} g16"),
                        "launches": sum(c[r["name"]] for p, c in path_counts.items()
                                        if p.startswith(LLAMA405_LABEL)),
                        **g16[r["name"]]}
        if r["name"] in m71:
            r["m71"] = {"max_abs_err": errs[f"{r['name']} m71"],
                        "launches": path_counts[MQA71_LABEL][r["name"]], **m71[r["name"]]}
    print(f"  phase 5i: {time.perf_counter() - t0:.1f} s")
    print("[5j] numbers of B4's partials at a ring step of phase 4q's shape, and the unrolled "
          "ring, the all-gather route, P and SDPA over its 32768 tokens")
    t0 = time.perf_counter()
    rows += sp_rows(torch, flash_chunked, flash_fwd)
    rows[-1]["runtime_attributes"] = runtime_attributes(b4_report, "B4 D128 bf16 partials")
    rows[-1]["sequence_parallel"].update(sp_numbers)
    print(f"  phase 5j: {time.perf_counter() - t0:.1f} s")
    print("[5k] numbers at pitched head dims: the \"o\" entries of every kernel row with a head "
          "dim at D 100 (two-byte rows, pitch 104) or D 40 (one-byte rows, pitch 48), each with "
          "the kernel's ms at D 104 / D 48 (\"pitch_cost\"); the \"phi3\" entries of the "
          "P-i8, B2-i8 and K8 rows at phase 3o's path")
    t0 = time.perf_counter()
    o_rows = pitched_rows(torch, ops, torch.Generator(device="cuda").manual_seed(86))
    phi3_i8 = phi3_int8_rows(torch, flash_fwd, torch.Generator(device="cuda").manual_seed(87))
    for r in rows:
        name = r["name"]
        if name in o_rows:
            r["o"] = {"max_abs_err": errs.get(f"{name} o100", errs.get(f"{name} o40")),
                      "launches": sum(c[name] for p, c in path_counts.items()
                                      if p.startswith(PITCHED_LABEL)), **o_rows[name]}
        if name in phi3_i8:
            r["phi3"] = {"max_abs_err": errs[f"{name} phi3"],
                         "launches": path_counts[PHI3_INT8_LABEL][name], **phi3_i8[name]}
    print(f"  phase 5k: {time.perf_counter() - t0:.1f} s")
    print(f"[5l] head dims from 257 to 512 (the wide layout of P / B2 and B12) at "
          f"DeepSeek-V4-Flash's attention widths ({V4_HQ} / {V4_HKV} heads, D {V4_D}, bf16): "
          f"the entry points on path {V4_LABEL!r} vs plain, d {V4_SMALL_DIMS} at B 1 x "
          f"{V4_SMALL_S}, then the \"v4\" entries of the P, B2 and B12 rows")
    t0 = time.perf_counter()
    phase_v4_widths(torch, ops, kernels, path_counts, errs)
    v4 = v4_rows(torch, ops, torch.Generator(device="cuda").manual_seed(88), path_counts, errs,
                 (fwd_report, b12_report))
    for r in rows:
        if r["name"] in v4:
            r["v4"] = v4[r["name"]]
    print(f"  phase 5l: {time.perf_counter() - t0:.1f} s")
    print(f"[5m] head dims from 257 to 512 in B4 (with its partials) and B6 (the wide layout) "
          f"and sequence-parallel attention at DeepSeek-V4-Flash's attention widths ({V4_HQ} / "
          f"{V4_HKV} heads, D {V4_D}, bf16, window {V4_WINDOW}): the entry points on path "
          f"{V4X_LABEL!r} vs plain, the ring and all-gather over {V4X_SP.ranks} ranks at "
          f"{V4X_SP.s} tokens vs P / B2 (path {V4X_SP.label!r}), the one-rank NCCL mesh (path "
          f"{V4X_SP.nccl_label!r}), d "
          f"{V4_SMALL_DIMS} at a small size, then the \"v4\" entries of the B4, B4-partials and "
          f"B6 rows")
    t0 = time.perf_counter()
    v4x_numbers, reach = phase_v4_extend(torch, ops, kernels, path_counts, errs)
    v4x = v4x_rows(torch, ops, torch.Generator(device="cuda").manual_seed(89), path_counts, errs,
                   (b4_report, b6_report))
    v4x["flash_chunked_partials"]["sequence_parallel"].update(v4x_numbers)
    v4x["flash_chunked"]["row_tol_reach"] = reach
    for r in rows:
        if r["name"] in v4x:
            r["v4"] = v4x[r["name"]]
    print(f"  phase 5m: {time.perf_counter() - t0:.1f} s")
    print(f"[5n] head dims from 257 to 512 in the decodes D1, B5, B7 and B8 with D2, the append "
          f"and QA, and in B9, at DeepSeek-V4-Flash's attention widths ({V4_HQ} / {V4_HKV} "
          f"heads, D {V4_D}, bf16 q over bf16, int8 and e4m3 values): admission and "
          f"{V4D_STEPS} decode steps on path {V4D_LABEL!r} vs plain, d 260 and 320 at a small "
          f"size, then the \"v4\" entries of the D1, D2, B5, B7, B8, B9, append and QA rows")
    t0 = time.perf_counter()
    streams = phase_v4_decode(torch, ops, paged_cache, kernels, path_counts, errs)
    v4d = v4d_rows(torch, ops, paged_cache, streams, path_counts, errs,
                   (d1_report, b7_report, b5_report, b8_report, b9_report))
    del streams
    torch.cuda.empty_cache()
    for r in rows:
        if r["name"] in v4d:
            r["v4"] = v4d[r["name"]]
    print(f"  phase 5n: {time.perf_counter() - t0:.1f} s")
    print(f"[5o] head dims from 257 to 512 in the backward B13a / B13b (the layout of 512) and "
          f"training through ops.autodiff.flash_attention at DeepSeek-V4-Flash's attention "
          f"widths ({V4_HQ} / {V4_HKV} heads, D {V4_D}, bf16): gradients at S {V4T_S} vs plain, "
          f"causal and with the window of {V4_WINDOW}; {V4T_STEPS} AdamW steps of each on path "
          f"{V4T_LABEL!r}; d {V4T_SMALL_DIMS} at a small size; D 520 refused; then the \"v4\" "
          f"entries of the B13a and B13b rows")
    t0 = time.perf_counter()
    phase_v4_train(torch, ops, kernels, path_counts, errs, rel_errs)
    v4t = v4t_rows(torch, ops, torch.Generator(device="cuda").manual_seed(90), path_counts, errs,
                   rel_errs, bwd_report)
    for r in rows:
        if r["name"] in v4t:
            r["v4"] = v4t[r["name"]]
    print(f"  phase 5o: {time.perf_counter() - t0:.1f} s")
    # Peak over the whole script: serving reset the counter before each run.
    numbers["max_memory_allocated_gb"] = max(
        [numbers["max_memory_allocated_gb"], serving.pop("peak_before_serving_gb")]
        + [r["peak_memory_gb"] for r in serving.values()]
        + [f["peak_memory_gb"] for f in families.values()] + [training["peak_memory_gb"]]
        + [training_gemma2["peak_memory_gb"], training_phi3["peak_memory_gb"]])
    print(json.dumps(profile))
    print(json.dumps(numbers))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"speculative": speculative}))
    print(json.dumps({"families": families}))
    print(json.dumps({"training": training}))
    print(json.dumps({"training_gemma2": training_gemma2}))
    print(json.dumps({"training_phi3": training_phi3}))
    print(json.dumps({"hf": hf_numbers}))
    print(json.dumps({"pitched_models": pitched_models}))
    print(json.dumps({"kernels": kernel_entries(rows, errs, path_counts)}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
