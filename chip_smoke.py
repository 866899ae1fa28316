#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]
    python3 chip_smoke.py --four-cards   # phase 19 (b) on 4 cards, NCCL

Phases, each printing one JSON line (any failure exits non-zero and
prints no result):

1. env          — the card (nvidia-smi name and power limit), torch and
                  CUDA versions; the card must be compute capability 9.0
                  (Hopper).
2. build        — build the kernels from deeplearning4j_tpu_torch/csrc/;
                  per kernel function, ptxas's registers and spill bytes
                  and, from `cuobjdump -sass` of the library, its HGMMA
                  (wgmma) and HMMA (mma.sync) instructions. Fails if a
                  bf16 K1, K2 or K3 instantiation holds neither or
                  spills, or if a K4 split or combine instantiation is
                  missing or spills.
3. kernels      — every ported kernel against its plain PyTorch version on
                  the card: the flash forward (K1) at B*H = 64, T in
                  {1, 16, 63, 65, 100, 128, 129, 1000, 1024}, Tq 64 < Tk
                  1024 and Tq 200 > Tk 37 (the edges of the bf16 kernels'
                  64-key tiles and 128-row blocks), hd 64 and 128, causal
                  or not; the paged decode (K4) at 13 slots, page_size
                  16, 64 pages per slot, ragged cursors (0, ps-1, ps, on
                  the boundaries of its 64-position splits, the window
                  edge, past it) and an idle all-trash slot.
                  float32 within 2e-5, bfloat16 within 2e-2 (unit-scale
                  inputs; the summation order differs). The float32 flash
                  cases are also held against blockwise_attention, the
                  online-softmax plain form. Then the flash backward, dQ
                  (K2) and dK/dV (K3), with an lse cotangent, at the same
                  B*H, hd, causal settings and shapes: within 1e-4
                  (float32) and 3e-2
                  (bfloat16) of the largest |plain| value, and in float32
                  also against torch.autograd.grad of blockwise_attention.
4. parity       — the model at full width (d_model 1024, 8 heads, d_ff
                  4096, vocab 8192) cut to 2 layers, float32:
                  teacher-forced batched prefill logits and 8 decode-step
                  logits on the card (kernels) against the same weights on
                  the CPU (plain versions), within 1e-3.
5. serve        — the serving path at full width: the 8-layer
                  110M-parameter LM in bfloat16 behind
                  InferenceEngine.for_transformer(..., decode_slots=8,
                  page_size=16), 16 requests with prompt lengths in
                  [16, 768] drawn from the seed, 64 new tokens each. Every
                  stream must finish, every page must come back (free, or
                  cached unreferenced by the prefix cache), both kernels
                  must have been launched on this path, and the decode
                  step must run as one captured CUDA graph.
5b. serve_features — the decode loop's serving features on the same
                  model (8 slots, page_size 16, 512 pages), each loop
                  ticked by hand with the page invariant (free + in use
                  + cached-unreferenced == n_pages) checked after every
                  tick: the prefix cache (16 requests on a 256-token
                  head, a seeding wave then 3 cold (opted out) and 3
                  warm waves: warm hits 16 and prefills at least 16 x
                  256 tokens fewer; a fully covered prompt forks once
                  and prefills nothing; time to first token each);
                  phase 5's requests eager at horizon 1 and as a CUDA
                  graph at horizon 1 and 8; speculation with the ngram
                  drafter (k 4) and a 2-layer d 512 model drafter (k 3)
                  (two graphs; K4 (k+1) x layers a verify replay, K1
                  counted in the drafter, acceptance; the drafter's
                  proposals on the windows the run gave it against the
                  same drafter with K1's plain version, K1 against its
                  plain version on the drafter's own q, k, v and at its
                  shape B*H 32, T 32, causal, on unit-scale inputs);
                  8 batch streams then 4 interactive (a batch stream
                  preempted, every interactive one done, every page
                  back). Warm against cold, each graph against eager
                  and speculation against eager give identical tokens,
                  or EVERY stream's first difference is a near-tie: both
                  tokens within the bf16 tolerance (2e-2) of the top
                  logit of transformer_logits there, and where the
                  arithmetic differs (warm against cold, speculation
                  against eager) within two bf16 steps at that logit's
                  magnitude, what the rounding of both runs' logits
                  alone allows (one graph; K4 horizon x layers a
                  replay; replay and launch ms; a steady window
                  profiled).
5c. serve_features_parity — 2 layers, float32, on the card: warm
                  against cold prefix, speculative (ngram and model
                  drafter) against plain, horizon 4 against horizon 1
                  give identical tokens (or every first difference a
                  near-tie within 1e-3); the model drafter with K1
                  against its plain version the same way;
                  paged_verify_step column by column against
                  paged_decode_step's logits within 1e-3.
5d. http_serve   — serve_network in-process on the card: /predict runs
                  BASELINE config 1's MLP (784-2048-1024-10, bf16
                  products) through ReplicaSet and MicroBatcher, 2,048
                  rows from 8 concurrent clients, against net.output
                  within the bf16 tolerance (p50/p99 latency, the
                  batcher's mean batch); /generate runs the 110M bf16 LM
                  (8 slots, page_size 16, 512 pages): phase 5's 16
                  requests, half streamed, once in request order (the
                  scheduler's first pass held by a chaos delay while the
                  staggered arrivals queue) with tokens equal to an
                  in-process DecodeLoop's, then all at once outside the
                  prefix cache (tokens/s, TTFT p50, wall and replay ms a
                  dispatch beside the in-process loop's; identical or
                  near-ties), again with no row streamed, with a 0.1 ms
                  thread switch interval and with the clients in a
                  process of their own; /readyz
                  200 after the warmup, recompiled_after_warmup, the
                  dl4j_decode_* series and dl4j_device_memory_bytes on
                  /metrics, every page back, one decode graph; then
                  `python -m deeplearning4j_tpu_torch.cli serve --smoke`
                  as a subprocess, its announce line with the JAX CLI's
                  keys. K1 and K4 counted as the "http" path.
5e. disagg       — three servers on the card (role prefill, role decode,
                  unified; fleet_kv "on"): 16 prompts on a 256-token
                  head with tails of 16-256 tokens, each POST /prefill
                  to the prefill server, then /generate (streamed) on
                  the decode server with kv_donor naming it. The shipped
                  pages bit-equal to the donor's, read from both pools;
                  the decode server prefills only the tokens past the
                  shipped full pages; its tokens equal the unified
                  server's warm run (its own /prefill then /generate)
                  and, by the near-tie rule, its cold run; the prefill
                  server captured no decode graph and ran no dispatch; a
                  chaos fleet.kv_ship error falls back to a plain prefill
                  with the unified cold run's tokens; every pool
                  balanced. Ship bytes, ms a shipped page, handoff TTFT
                  against unified cold TTFT. K1 on the prefill role and
                  K4 on the decode role counted as the "disagg" path.
5f. fleet        — the fleet and its router (serving/fleet.py,
                  serving/router.py) over replicas of the same model (8
                  slots, page_size 16, 512 pages each). (a) Two
                  serve_network servers on threads of this process, attached
                  by URL behind serve_fleet: phase 5's 16 requests through
                  the router, half streamed, twice (the first round captures
                  both loops' step graphs, one at a time; the timed round
                  runs outside the prefix cache), identical to an in-process
                  DecodeLoop or near-ties; a mid-stream failover (a chaos
                  reset of the serving replica's stream): token_index
                  gapless and without duplicates, dl4j_fleet_stream_resumes
                  >= 1 on the router's /metrics, the resumed tokens equal
                  the uninterrupted run's or the first difference is a near-
                  tie (the survivor re-prefills prompt + delivered through
                  K1 or the float32 context path, the victim decoded them
                  through K4: in bf16 not bit-identical); a rolling /reload
                  of the served network from a step-7 checkpoint: 200, both
                  replicas report step 7 on /readyz, /predict equal to the
                  saved network, the tokens of a request unchanged, every
                  pool balanced. (b) Two `cli serve --device cuda` processes
                  spawned by ReplicaSpawner, sharing the card (weights from
                  the same SPEC and seed): the same two rounds through the
                  router, identical to the in-process loop or near-ties;
                  each child's /stats shows decode-graph launches > 0 (read
                  there: the children's launches are not counted on any
                  path); after Fleet.close(stop_replicas=True) no child or
                  process group is left. Boot-to-ready seconds, tokens/s and
                  TTFT p50 through the router (two processes time-slice one
                  card: not gated). (c) A prefill-role and a decode-role
                  server attached; the router drives /prefill and then
                  kv_donor for the disagg phase's 16 prompts: 16 handoffs,
                  none failed, the decode replica prefills only the tails,
                  the prefill replica ran no dispatch and captured no graph,
                  the tokens equal the disagg phase's handoff or are near-
                  ties, every pool balanced. K1 and K4 in (a) and (c)
                  counted as the "fleet" path.
6. train_parity — full width cut to 2 layers, float32, 2 x 301 tokens:
                  lm_loss and every gradient leaf on the card (K1 with its
                  lse, K2, K3) against the same weights on the CPU (plain
                  versions), then the params after 2 make_train_step
                  steps; limits in TRAIN_PARITY_TOL.
7. train        — the training path at full width: the 8-layer 110M bf16
                  LM at B 8 x 1025 tokens (T 1024 reaches the model) on a
                  cyclic, learnable token sequence: TRAIN_STEPS
                  make_train_step steps, then fit_scan over the batches.
                  Every loss finite, the last step's loss and fit_scan's
                  below half the first step's, and K1, K2 and K3 each
                  launched exactly n_layers times a step (counted).
                  Tokens/s and step ms by CUDA events.
8. multilayer_parity — the layer network (MultiLayerNetwork) at full
                  width, float32, card against CPU on the same weights:
                  LeNet as __graft_entry__.entry() builds it, the MLP
                  784-2048-1024-10 and the row-sequence attention stack
                  (reshape to 28 x 28 -> self_attention 28 -> 128, one
                  head of 128 -> flatten -> softmax output 784 -> 10), at
                  batch 64: the outputs, then the params after 2 fit
                  steps over an iterator through the DeviceFeed (64
                  rows, then 40 padded to 64 and masked); limits in
                  ML_PARITY_TOL.
9. multilayer_train — the layer network's main path at the BASELINE
                  widths, bfloat16 products, on synthetic_mnist: the MLP
                  (batch 4096, AdaGrad lr 0.05, 16 batches), LeNet (batch
                  1024, SGD lr 0.05, 8 batches) and the attention stack
                  (batch 1024, SGD lr 0.05, 8 batches). Two epochs of
                  fit_scan one batch a call (each step timed by CUDA
                  events), one whole fit_scan epoch under
                  torch.cuda.set_sync_debug_mode("error") (no host sync
                  may happen inside it), then whole epochs until the last
                  loss is below half the first (at most bench.py's epoch
                  count), then Evaluation of output() on 2048 held-out
                  rows. Every loss finite, the last below half the first,
                  and on the attention stack K1, K2 and K3 each launched
                  once a step (K1 once more for output()). One step of
                  each model profiled.
10. solver_parity — the batch solvers (optimize/): each of the five
                  optimizers, 5 iterations over a 20-32-16-5 MLP's loss
                  (float32, batch 64; Hessian-free from damping 10),
                  card against the port's CPU run from the same params
                  and batch (params within 1e-4); on the card the
                  sync-free path and the listener path give identical
                  params, and one optimize() of each runs under
                  set_sync_debug_mode("error"). Then Hessian-free's
                  double backward through the bf16 product on a bf16
                  conf: the Hessian-vector product card vs CPU within
                  3e-2 of its largest value, the final score within 2e-2
                  relative. Limits in SOLVER_PARITY_TOL.
11. dbn          — BASELINE config 4 at full width (bench.py:241-256):
                  784-1024-512-10 DBN, CD-1 pretraining of both RBMs then
                  5 backprop steps, bf16 products, batch 2048 of
                  synthetic_mnist. One warm-up fit, 12 timed fits
                  (samples/s as bench.py counts: fits x 2048 x 5 x 3 /
                  window), one fit under set_sync_debug_mode("error"),
                  RBM reconstruction errors and the score before and
                  after, Evaluation on 2048 held-out rows, one fit
                  profiled; the card's name and power limit beside it.
                  Every value finite and the score lower at the end.
12. solver_attention — the attention stack of phase 9 trained by
                  conjugate_gradient and by lbfgs, two fit() calls of 5
                  iterations each: K2 and K3 launched once per gradient,
                  K1 once per gradient (with its lse) plus once per
                  line-search trial (all 5 run on the sync-free path);
                  the loss lower at the end; ms per iteration.
13. checkpoint   — BASELINE config 1 (784-2048-1024-10, bf16 products)
                  after 2 fit steps: a ShardedModelSaver step written
                  from the card restores on the CPU and one written from
                  the CPU restores on the card (params, hist, velocity,
                  iteration, iteration_count, cursor, metadata
                  bit-equal); DefaultModelSaver / load_checkpoint the
                  same; a bf16 leaf bit for bit; a step without COMMITTED
                  invisible; a flipped byte raises CorruptShardError.
                  Bytes a checkpoint, snapshot ms (fit thread), write ms
                  (writer thread), restore ms.
14. resume       — BASELINE config 1, 16 batches of 4096 through a
                  DeviceFeed, 2 epochs, guardian (check 4, snapshot 8),
                  autosave every 4 batches (keep 3): run A uninterrupted;
                  run B preempted after batch 10 and batch 21, each time
                  restored on the card by restore_network and resumed
                  (start_*, fast_forward); A and B bit-equal (params,
                  updater state, iteration_count). Then the guarded
                  fit_scan (checkpoint_every=1 epoch) preempted at epoch
                  2 and resumed, bit-equal to its uninterrupted run. Each
                  save's snapshot and write ms, each restore's ms, the
                  largest in-flight count.
15. guardian     — bench.py:364 bench_guardian: (a) guarded (never
                  checking) vs unguarded BASELINE config 1, fit and
                  fit_scan bit-equal, ms a step, kernels a step, a
                  guarded epoch under set_sync_debug_mode("error"); (b)
                  the Iris drill, one poisoned batch of 24 in 150, score
                  within 1e-3 of the clean run; (c) the attention stack
                  (bf16, batch 1024) skips a batch with a NaN row, params
                  and updater state bit-unchanged, K1-K3 once a step;
                  K1 (bf16, float32) and K2/K3 non-finite where their
                  plain versions are; (d) a persistent-NaN schedule:
                  rollbacks at lr_scale 0.5 and 0.25, then GuardianAbort
                  with the network on its last-good snapshot, the events
                  those of the CPU run.
16. readers      — BASELINE config 1 fed from a CSV of 8,192
                  synthetic_mnist rows with an integer label column: the
                  native library (runtime/native/native.cpp) built under
                  build/native/ (no numpy fallback); np.loadtxt and the
                  native read_csv bit-equal to the rows written (rows/s);
                  CSVDataSetIterator -> AsyncDataSetIterator ->
                  DeviceFeed -> fit, 2 epochs at batch 4096, params
                  bit-equal to ListDataSetIterator -> DeviceFeed -> fit;
                  the async queue's batches/s alone; fit samples/s
                  through the async path (CSV and in-memory sources) and
                  the list path; a producer error mid-stream relayed to
                  fit.
17. cli          — the command line in-process (cli.main): `train
                  --batch-size 4096 --epochs 2 --checkpoint-dir` from a
                  port-written init.ckpt bit-equal to the same fit through
                  the API; test, predict, eval --json and checkpoint
                  inspect --json return 0 with the JAX CLI's shapes of
                  output; 1 epoch then `--resume auto --epochs 2`
                  bit-equal to the 2-epoch run, its autosaves numbered on;
                  the attention stack trained and tested through the CLI
                  with K1-K3 counted; one subprocess `python3 -m
                  deeplearning4j_tpu_torch.cli test` gives the in-process
                  metrics. CLI wall time and time to first step.
17b. pipeline    — the train -> serve conveyor (deploy/controller.py,
                  cli pipeline) over the attention stack, bf16: what
                  telemetry costs a step (host syncs equal with it on
                  and off, params bit-identical); (a) `cli train` (batch
                  1024, 12 steps, an autosave every 4, --metrics-port 0,
                  --trace) commits steps 4, 8, 12, then a copy of step
                  12 with its output weights negated (13) and BASELINE
                  config 1's trained MLP (14) are committed; a
                  DeploymentController on the card (eval gate on 1,024
                  held-out rows, f1 >= 0.5, a /predict probe, a state
                  dir, a status port) drives a Fleet of two
                  serve_network replicas on threads: 14 fails its
                  canary, 13 the gate, 12 is promoted. Gates: the
                  verdicts and QUARANTINED markers, every replica's
                  /stats and /readyz on step 12, /predict within the
                  bf16 tolerance of step 12 restored on the card, the
                  gate's classes against a float32 CPU gate (each
                  differing row a near-tie), dl4j_pipeline_* on the
                  status port, the trainer's /metrics (steps and
                  commits) and trace, live allocated memory (cyclic
                  garbage collected before each reading) back to its
                  value before each gate and, after every cycle, before
                  the first, a journal left in CANARY by a dead owner
                  re-driven to the same verdict; (b) `cli pipeline
                  --spawn-fleet` as a subprocess with two `cli serve
                  --device cuda` replicas and a state dir: exit 0, the
                  JAX CLI's announce keys, step 12 promoted, and once
                  the handed-off replicas are stopped no process of
                  their groups left. K1-K3 counted as the "pipeline"
                  path; commit-to-serving seconds, eval and promote
                  seconds, checkpoint write seconds.
18. lstm         — models/lstm.py: card vs CPU in float32 (d 32, T 16,
                  B 4; activate, loss, gradients of R, Wd, bd, 3 SGD
                  steps, chunked run_stream; outputs within 1e-5 (the
                  loss relative), params within 1e-4); then bytes at full
                  width (n_in = hidden = n_out = 256, T 128, B 64, bf16
                  products, SGD lr 0.02, 60 steps on "hello world "
                  read cyclically): the loss halves, chunked run_stream
                  equals activate, a 5-beam 20-step beam search returns
                  sorted beams; ms a step by CUDA events, tokens/s,
                  kernels a step and busy share, ms a beam tick.
19. parallel     — parallel/ and attention/ring.py. (a) World size 1 on
                  NCCL in this process (multihost.initialize on a free
                  local port, make_mesh({"data": 1})): BASELINE config 1
                  (16 x 4096, 2 epochs) under DataParallelTrainer bit-equal
                  to MultiLayerNetwork.fit through its DeviceFeed (else the
                  largest difference, gated at the bf16 tolerance), ms a
                  step against fit's by CUDA events; ShardedUpdateTrainer
                  within 1e-5 of DP; ParameterAveragingTrainer(local_steps
                  4) within 1e-5 of the same wave's steps run by hand (no
                  batch count to the updater, as the JAX package's wave;
                  fit() divides AdaGrad's step by the batch, so it is not
                  the reference); a DP epoch under set_sync_debug_mode(
                  "error"); the attention stack (bf16, 8 x 1024) under DP
                  with K1, K2 and K3 once a step and its params bit-equal
                  to fit's; a guarded DP run and a ZeRO-1 run autosaving
                  through ShardedModelSaver(mesh=, strategy=) restore bit-
                  equal (restore_params_for, restore_network,
                  restore_flat_state). (b) PAR_RANKS (4) spawned ranks
                  sharing the card (testing/ranks.py), each joining by
                  multihost.initialize, every mesh gloo given explicitly
                  (CUDA tensors staged through the host, bytes counted):
                  ring_attention(local="flash") at the LM's attention shape
                  (B 8, H 8, hd 128, T 1024, 256 positions a rank, bf16),
                  causal and not, forward within 2^-7 + 2^-6 |ref| of one
                  flash_attention over the whole sequence and of
                  local="einsum" element by element, dQ / dK / dV within
                  3e-2 of the largest |whole-sequence flash backward|
                  value, K1 = K2 = K3 = 10 causal and 16 not over the
                  ranks; config 1 under DP at 4 ranks (1,024 rows a rank)
                  and TP on {"data": 2, "model": 2}, their params within
                  0.05 of the training's own movement (||p - p_fit|| /
                  ||p_fit - p0||) of one process's fit and of each other,
                  while a fit on a quarter of every batch and no training
                  lie beyond it, and TP's score within rtol 2e-3 of DP's;
                  the pipeline (4 stages, d 1024, 8 microbatches of
                  512) forward and one grad step, and the experts (E 4,
                  d_in 1024, d_hidden 4096, 4,096 tokens) dense and a2a at
                  capacity 4, within 1e-5 (float32, relative to the largest
                  |reference| value) of sequential_apply / moe_reference,
                  the a2a dropped-token count at capacity 1 equal to the
                  ranks' own routing's. Each rank's host-staged bytes and
                  the group's wall time (four processes time-slice one
                  card: no speed is gated or called scaling); whether NCCL
                  takes two ranks on one card (a spawned 2-rank probe,
                  recorded, not gated). K1-K3 of (a)'s stack counted as the
                  "parallel" path, the ring's as the "ring" path.
                  `--four-cards` runs the build and (b) alone with one rank
                  on each of 4 cards over NCCL, the meshes' default there,
                  no byte staged through the host (gated).
20. nlp          — the word-vector stack (nlp/, utils/viterbi.py), which
                  launches none of K1-K4 (gated: 0 on every counter).
                  (b) BASELINE config 3 (bench.py:290-329): 200k zipfian
                  tokens (bench.py's _zipf_sentences, seed 0), vocab 2k,
                  dim 128, window 5, batch_pairs 4096, chunk_batches 32,
                  with negative sampling (neg 5) and with HS, the pairs
                  mined once and uploaded once: pairs/s over 3 timed
                  train_pairs windows, mine s, ms, kernels and device ms
                  a batch, busy share (a chunk profiled), host syncs in
                  a chunk (0, gated), finite tables, and the first
                  chunk's loss lower after the windows (gated). (a) Card
                  against CPU at that width from the same start: one
                  train_pairs chunk (32 x 4096 pairs) with the same
                  injected negatives, the same chunk with HS, one GloVe
                  epoch in the same order; every table (and GloVe's
                  accumulators) within 1e-4 of its largest |entry|
                  (float32; the card's scatters sum in another order).
                  (c) BASELINE config 5 (bench.py:332-361): the same
                  corpus, dim 128, batch 8192, prepare once, 2 windows
                  of 16 epochs: triples/s, prepare s, kernels a step,
                  busy share, 0 syncs inside an epoch and the final loss
                  below the first epoch's (gated). (d) BASELINE config
                  3c (BASELINE.md:86): ParagraphVectors, dim 128, neg 5,
                  3 iterations, 100k documents of 20 tokens over 20
                  topics (each drawn zipfian from its topic's 500 words
                  of a 10k vocab, labelled by its topic), end to end
                  through fit: pairs/s, word -> own-label retrieval on
                  200 seeded probe words >= 0.9 (gated). (e) The
                  config-3 vectors saved and loaded in both formats
                  (binary bit-equal; text, 6 significant digits as the
                  JAX package writes, saves again to the same bytes);
                  Viterbi on 64 seeded sequences: decode on the card
                  equal to the CPU's float32 decode and optimal for the
                  numpy backend (its exact ties may break apart
                  differently in float64), viterbi_path on the card
                  equal to the numpy backend on tie-free random HMMs;
                  Word2VecDataSetIterator yields one (64, 640) batch.
                  Writes under build/chip_smoke_nlp/ and removes it;
                  hands config 3c's word vectors, their topic ids and
                  counts to phase 22.
21. rntn         — the tree stack (nlp/tree.py, rntn.py, pos.py,
                  sentiment.py), which launches none of K1-K4 (gated).
                  A seeded corpus of SST's shape (sst_corpus: 8,544 /
                  1,101 / 2,210 sentences, lengths 1-56 with mean ~19,
                  zipfian 16k words, random-split bracketing, a gold
                  label on every node from seeded word polarities);
                  the reference's width: num_hidden 25, tensors on,
                  tanh, simplified, 5 classes. (a) Card against CPU
                  from the same parameters: 1,024 trees for 3 epochs,
                  and the per-category model (8 syntactic labels,
                  binary classification) on 256 trees for 2 epochs:
                  the gradient before the first update, every epoch's
                  loss within 1e-5 relative, every table and AdaGrad
                  history within 1e-4 of its largest |entry|, T within
                  1e-3 (gated; RNTN_TOL has the reading behind T's
                  bound; each table's worst entry is recorded with the
                  CPU's |g| there before each epoch's update). (b) fit on the 8,544 trees, 50 full-batch
                  epochs: 0 syncs before the final read, finite tables,
                  the loss at epoch 50 below epoch 1's, the level count
                  equal to the tallest tree's depth and below max_nodes
                  (gated); ms an epoch, trees/s, nodes/s, kernels and
                  device ms an epoch, busy share (an epoch profiled).
                  (c) output on the 2,210 test trees, predict and
                  forward_propagate_tree on 64 of them: predict's class
                  equal to output's, roots from predict within 1e-6 of
                  output's, per-node vectors, predictions and errors
                  within 1e-4 of a CPU copy's, each bound raised to 4x
                  the CPU's own float32 error against a float64 copy
                  where the trained model is that sensitive (gated);
                  root accuracy beside the majority-class rate. (d) HmmPosTagger trained on the train yields,
                  tagging the test yields, the lexicon classifying them,
                  annotate_windows over one sentence (tokens/s, host).
22. clusters     — clustering/ and plot/ over config 3c's 10,020 x 128
                  word vectors, which launch none of K1-K4 (gated).
                  (a) KMeansClustering(k=20, max_iterations=100,
                  tol=1e-4) card against CPU: assignments equal except
                  near-ties (two nearest squared distances within 1e-5
                  relative), centroids within 1e-4 (gated); ms and
                  kernels an iteration, iterations, topic purity.
                  (b) Exact Tsne at its defaults (perplexity 30, 500
                  iterations) over the 100 most frequent words of each
                  topic (2,000 points): the first 10 iterations card
                  against CPU from the same start within 1e-4 of max |y|
                  (beside the CPU against itself from a start one ulp
                  away), 0 syncs in the loop, a finite embedding
                  (gated); host affinity s, device ms, kernels and busy
                  share an iteration, 10-NN topic agreement in 2-D
                  beside 128-D. (c) BarnesHutTsne on 256 of them, 300
                  iterations (host numpy): finite. (d) serve_coords over
                  the embedding: GET /api/coords returns the 2,000
                  coordinates and labels, and the server closes.
                  (e) KDTree and VPTree k-NN (k 10, 64 queries) on the
                  10,020 vectors equal to brute force. (f)
                  interop.to_device on the card. (g) phase 21's
                  parameters through utils.serialization bit-equal.
The phases 16-18 write under build/chip_smoke_cli/ and remove it; phase
5f writes under build/chip_smoke_fleet/ and phase 17b under
build/chip_smoke_pipeline/ and phase 19 under build/chip_smoke_parallel/,
each removing it.

Then, at each path's shapes: each kernel's time beside its plain
version's, the library call's (SDPA for K1, SDPA's backward for K2 + K3;
the median of 3 separate batches, all three recorded) and its bound, one
whole prefill, decode step and training step, each profiled; K1, K2 and
K3 also at the attention stack's shape (B*H 1024, T 28, hd 128, not
causal), K1 at the model drafter's shape, and K1, K2 and K3 at the
ring's shard shape (B*H 64, T 256, hd 128, causal and not). The kernels'
launches are counted per path, a captured graph's replays included
(serve, serve_features, spec, draft, http, disagg, fleet, train,
multilayer, solver, guardian, cli, pipeline, parallel, ring, and nlp,
rntn and clusters, which are 0).
The last lines are the card as nvidia-smi gives it, the kernels' JSON
line (with each kernel's design), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch.attention import blockwise, flash, paged
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import (DataSet, DataSetIterator,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import synthetic_mnist
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.models import transformer as transformer_mod
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, fit_scan, init_transformer_params, init_velocity,
    lm_loss_and_grads, make_train_step, transformer_logits)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.preprocessors import (
    ConvolutionInputPreProcessor, ConvolutionPostProcessor,
    ReshapePreProcessor)
from deeplearning4j_tpu_torch.ops.products import bf16_product_route
from deeplearning4j_tpu_torch.optimize import CollectScoresListener, Solver
from deeplearning4j_tpu_torch.optimize.solvers import ravel_table
from deeplearning4j_tpu_torch.serving import paged_kv
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.weights import params_to_device

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: K2/K3 against their plain version, relative to the largest |plain|
#: value: float32 sums in another order; bfloat16 P and dS round at the
#: same points, but a value near a rounding edge may round the other way
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: the 110M LM (d_model 1024, 8 layers, hd 128, vocab 8192, bf16)
FULL = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=8,
                         n_layers=8, d_ff=4096, max_len=1024,
                         dtype=torch.bfloat16)
SLOTS, PAGE_SIZE, N_REQUESTS, MAX_TOKENS = 8, 16, 16, 64
#: (Tq, Tk) of the flash kernels' cases: the path's buckets, the edges of
#: the bf16 kernels' tiling (64-key tiles, 64-row warpgroups, 128-row
#: forward blocks), Tq < Tk, and Tq > Tk (causal rows that see no key)
FLASH_SHAPES = ([(t, t) for t in (1, 16, 63, 65, 100, 128, 129, 1000, 1024)]
                + [(64, 1024), (200, 37)])
#: how each kernel computes on the main path (bf16); every float32 flash
#: instantiation is a scalar f32 kernel (`build.functions` shows no HGMMA)
DESIGN = {"flash_fwd": "wgmma+cp.async", "flash_bwd_dq": "wgmma+cp.async",
          "flash_bwd_dkv": "wgmma+cp.async",
          "paged_decode": "split-page (cp.async 16-byte ring) + combine"}
#: the bf16 kernels that must run on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_kernel_wgmma", "flash_bwd_dq_kernel_wgmma",
                       "flash_bwd_dkv_kernel_wgmma")
#: K4's two kernels, launched once each by every wrapper call
PAGED_KERNELS = ("paged_decode_split_kernel", "paged_decode_combine_kernel")
#: the training path: B x (T + 1) tokens a batch, steps, batches, lr
#: (at lr 0.01 and above, SGD with momentum 0.9 overshoots on this data
#: after 3 steps and the loss climbs again)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_BATCHES, TRAIN_LR = 8, 1024, 10, 4, 5e-3
#: card vs CPU, float32, 2 layers: the loss (absolute; it is ~9), each
#: gradient leaf (relative to its largest |CPU| value; sums in another
#: order, the tied embedding's a scatter-add with atomics), the params
#: after 2 steps (absolute; parameters are ~0.02)
TRAIN_PARITY_TOL = {"loss": 2e-5, "grad": 1e-4, "embed_grad": 1e-4,
                    "params": 2e-6}
#: layer network, card vs CPU, float32: output probabilities (absolute;
#: sums of up to 2048 products in another order), params after 2 fit
#: steps (absolute; an AdaGrad step moves a weight by up to lr / batch =
#: 1.6e-3, and a gradient within rounding of zero may take the other
#: sign, moving that weight by up to lr / batch * |g| / (|g| + 1e-6))
ML_PARITY_TOL = {"forward": 1e-5, "params": 1e-4}
ML_PARITY_BATCH = 64
ML_PARITY_TAIL = 40  # rows of the second, ragged fit batch
#: the layer network's training path: (batch, batches, the most epochs
#: to train until the loss halves: bench.py's epoch counts) per model
ML_TRAIN = {"mlp": (4096, 16, 16), "lenet": (1024, 8, 32),
            "attention": (1024, 8, 32)}
ML_EVAL_ROWS = 2048


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: GPU clock cycles the device spins before each timed call (~1 ms at the
#: H100's 1.98 GHz boost)
HOLD_CYCLES = 2_000_000


class Timer:
    """Per-call device time with CUDA events, the 50 MB L2 flushed before
    each call so every input is read from device memory, as the serving
    loop finds it. The device spins for HOLD_CYCLES between the flush
    and the start event, so the host has enqueued the call before the
    device reaches it: the events time the device's work, not the host's
    Python and launch overhead (which, for a kernel of ~10 us, is most
    of an unheld measurement). A call whose enqueue outlasts the hold
    (a whole model step) still includes the rest of its host time."""

    def __init__(self, device):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10) -> float:
        fn()  # warm up
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def library_ms(timer, fn, batches: int = 3):
    """(median, every batch) of `batches` separate `Timer.ms` batches: a
    library call's time moves by up to 2x from one batch to the next."""
    runs = [timer.ms(fn) for _ in range(batches)]
    return sorted(runs)[len(runs) // 2], runs


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def live_allocated(device) -> int:
    """Device bytes held by live tensors. Unreachable reference cycles
    are collected first: Python's cyclic collector runs whenever its
    allocation counts say so, and one that runs between two readings
    would otherwise free an earlier phase's garbage and move them."""
    gc.collect()
    return torch.cuda.memory_allocated(device)


# ----------------------------------------------------------------- bounds
def visible_pairs(tq, tk, causal):
    """(query, key) pairs one batch*head row attends over."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(max(0, min(tk, i + off + 1)) for i in range(tq))


def flash_work(bh, tq, tk, hd, causal, dtype):
    """(bytes, operations) the flash forward must move and do: q, k, v
    read once and out written once; 4*hd operations per visible
    (query, key) pair (two products of 2*hd)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = bh * (2 * tq + 2 * tk) * hd * itemsize
    return nbytes, 4 * hd * bh * visible_pairs(tq, tk, causal)


def flash_bwd_work(kernel, bh, tq, tk, hd, causal, dtype):
    """(bytes, operations) of one backward kernel. Both read q, dO (Tq
    rows), k, v (Tk rows) and the float32 lse and D once. K2 ("dq")
    writes dQ and does 6*hd operations per visible pair (S, dP, dS.K);
    K3 ("dkv") writes dK and dV and does 8*hd (S, dP, P^T.dO, dS^T.Q)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = {"dq": 3 * tq + 2 * tk, "dkv": 2 * tq + 4 * tk}[kernel]
    nbytes = bh * rows * hd * itemsize + bh * tq * 2 * 4
    per_pair = {"dq": 6, "dkv": 8}[kernel] * hd
    return nbytes, per_pair * bh * visible_pairs(tq, tk, causal)


def paged_work(lengths, heads, hd, ps, width, dtype):
    """(bytes, operations) of one paged decode call: the written pages of
    K and V read once (the pages these cursors reach), q read and out
    written once, plus the table row and cursor; 4*hd operations per
    visible position."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    pages = sum(min(int(p) // ps + 1, width) for p in lengths)
    nbytes = (2 * pages * heads * ps * hd * itemsize
              + 2 * len(lengths) * heads * hd * itemsize
              + len(lengths) * (width + 1) * 4)
    positions = sum(min(int(p) + 1, width * ps) for p in lengths)
    return nbytes, 4 * hd * heads * positions


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ cases
def paged_inputs(gen, device, dtype, heads, hd, lengths, n_pages=512,
                 ps=PAGE_SIZE, width=64):
    """A pool and page tables with each slot's written pages scattered
    over the pool; an idle slot (cursor 0, last row) keeps an all-trash
    table."""
    s = len(lengths)
    trash = n_pages
    q = torch.randn(s, heads, hd, generator=gen).to(device, dtype)
    kp = torch.randn(n_pages + 1, heads, ps, hd, generator=gen).to(device,
                                                                  dtype)
    vp = torch.randn(n_pages + 1, heads, ps, hd, generator=gen).to(device,
                                                                  dtype)
    perm = torch.randperm(n_pages, generator=gen).tolist()
    table = torch.full((s, width), trash, dtype=torch.int32)
    nxt = 0
    for i, pos in enumerate(lengths[:-1]):
        for j in range(min(int(pos) // ps + 1, width)):
            table[i, j] = perm[nxt % n_pages]
            nxt += 1
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, table.to(device), lens.to(device)


def phase_kernels(device, timer, seed):
    gen = torch.Generator().manual_seed(seed)
    cases, worst = [], {"flash_fwd": 0.0, "paged_decode": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for tq, tk in FLASH_SHAPES:
                q = torch.randn(64, tq, hd, generator=gen).to(device, dtype)
                k = torch.randn(64, tk, hd, generator=gen).to(device, dtype)
                v = torch.randn(64, tk, hd, generator=gen).to(device, dtype)
                for causal in (False, True):
                    out, lse = flash.flash_attention_with_lse(q, k, v,
                                                              causal)
                    ref, ref_lse = flash.flash_attention_ref(q, k, v, causal,
                                                             True)
                    torch.cuda.synchronize()
                    err = max_err(out, ref)
                    lse_err = max_err(lse, ref_lse)
                    # causal rows that see no key: out 0 and lse +1e30
                    no_key = max(tq - tk, 0) if causal else 0
                    no_key_ok = bool((out[:, :no_key] == 0).all() and (
                        lse[:, :no_key] == -flash.NEG_INF).all())
                    ok = (err <= TOL[dtype] and lse_err <= 1e-3
                          and no_key_ok)
                    bw_err = None
                    if dtype == torch.float32:
                        # the online-softmax plain form, natural base
                        bw, bw_lse = blockwise.blockwise_attention(
                            q, k, v, causal, block_size=64, return_lse=True)
                        bw_err = max_err(out, bw)
                        ok = (ok and bw_err <= TOL[dtype]
                              and max_err(lse, bw_lse) <= 1e-3)
                    cases.append({
                        "kernel": "flash_fwd", "dtype": str(dtype),
                        "bh": 64, "tq": tq, "tk": tk, "hd": hd,
                        "causal": causal, "max_abs_err": err,
                        "lse_max_abs_err": lse_err,
                        "blockwise_max_abs_err": bw_err,
                        "no_key_rows": no_key,
                        "no_key_rows_exact": no_key_ok, "ok": ok,
                        "kernel_ms": timer.ms(
                            lambda: flash.flash_attention(q, k, v, causal),
                            iters=5),
                        "ref_ms": timer.ms(
                            lambda: flash.flash_attention_ref(q, k, v,
                                                              causal),
                            iters=3)})
                    worst["flash_fwd"] = max(worst["flash_fwd"], err)
                    if not ok:
                        raise AssertionError(f"flash kernel disagrees: "
                                             f"{cases[-1]}")
    window = 64 * PAGE_SIZE
    run = paged.pages_per_split(PAGE_SIZE) * PAGE_SIZE  # positions a split
    lengths = [0, PAGE_SIZE - 1, PAGE_SIZE, run - 1, run, 2 * run - 1,
               2 * run, 345, 700, window - 1, window, window + 1, 0]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            args = paged_inputs(gen, device, dtype, 8, hd, lengths)
            out = paged.paged_attention(*args)
            ref = paged.paged_attention_ref(*args)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            cases.append({
                "kernel": "paged_decode", "dtype": str(dtype),
                "slots": len(lengths),
                "heads": 8, "hd": hd, "page_size": PAGE_SIZE,
                "table_width": 64, "lengths": lengths,
                "max_abs_err": err, "ok": err <= TOL[dtype],
                "kernel_ms": timer.ms(lambda: paged.paged_attention(*args)),
                "ref_ms": timer.ms(lambda: paged.paged_attention_ref(*args),
                                   iters=3)})
            worst["paged_decode"] = max(worst["paged_decode"], err)
            if err > TOL[dtype]:
                raise AssertionError(f"paged kernel disagrees: {cases[-1]}")
    bwd, bwd_worst = bwd_cases(device, timer, gen)
    return cases + bwd, {**worst, **bwd_worst}


def rel_errs(got, ref):
    """max |got - ref| and that over max |ref|, per tensor."""
    out = []
    for a, b in zip(got, ref):
        err = max_err(a, b)
        out.append((err, err / max(float(b.float().abs().max()), 1e-30)))
    return out


def bwd_cases(device, timer, gen):
    """K2 and K3 (through `_flash_backward`, with an lse cotangent)
    against `flash_attention_bwd_ref` on the card; float32 also against
    autograd of blockwise_attention."""
    cases = []
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dq_rel": 0.0, "flash_bwd_dkv_rel": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for tq, tk in FLASH_SHAPES:
                q, do = (torch.randn(64, tq, hd, generator=gen)
                         .to(device, dtype) for _ in range(2))
                k, v = (torch.randn(64, tk, hd, generator=gen)
                        .to(device, dtype) for _ in range(2))
                g_lse = torch.randn(64, tq, generator=gen).to(device)
                for causal in (False, True):
                    out, lse = flash.flash_attention_with_lse(q, k, v,
                                                              causal)
                    args = (q, k, v, out, lse, do, causal, g_lse)
                    got = flash._flash_backward(*args)
                    ref = flash.flash_attention_bwd_ref(*args)
                    errs = rel_errs(got, ref)
                    ok = max(r for _, r in errs) <= BWD_TOL[dtype]
                    # rows that see no key (causal Tq > Tk): exactly zero
                    no_key = max(tq - tk, 0) if causal else 0
                    no_key_zero = bool((got[0][:, :no_key] == 0).all())
                    ok = ok and no_key_zero
                    bw_rel = None
                    if dtype == torch.float32:
                        leaves = [x.detach().requires_grad_()
                                  for x in (q, k, v)]
                        bw = torch.autograd.grad(
                            blockwise.blockwise_attention(
                                *leaves, causal, block_size=64,
                                return_lse=True), leaves, (do, g_lse))
                        bw_rel = max(r for _, r in rel_errs(got, bw))
                        ok = ok and bw_rel <= BWD_TOL[dtype]
                    torch.cuda.synchronize()
                    cases.append({
                        "kernel": "flash_bwd", "dtype": str(dtype),
                        "bh": 64, "tq": tq, "tk": tk, "hd": hd,
                        "causal": causal,
                        "max_abs_err": {n: e for n, (e, _) in
                                        zip(("dq", "dk", "dv"), errs)},
                        "max_rel_err": {n: r for n, (_, r) in
                                        zip(("dq", "dk", "dv"), errs)},
                        "blockwise_max_rel_err": bw_rel,
                        "no_key_rows": no_key,
                        "no_key_rows_dq_zero": no_key_zero, "ok": ok,
                        "kernel_ms": timer.ms(
                            lambda: flash._flash_backward(*args), iters=3),
                        "ref_ms": timer.ms(
                            lambda: flash.flash_attention_bwd_ref(*args),
                            iters=2)})
                    for name, idx in (("flash_bwd_dq", (0,)),
                                      ("flash_bwd_dkv", (1, 2))):
                        worst[name] = max(worst[name],
                                          *(errs[i][0] for i in idx))
                        worst[name + "_rel"] = max(
                            worst[name + "_rel"], *(errs[i][1] for i in idx))
                    if not ok:
                        raise AssertionError(f"flash backward kernels "
                                             f"disagree: {cases[-1]}")
    return cases, worst


def phase_parity(device, seed):
    """Full width cut to 2 layers, float32: card (kernels) vs CPU (plain
    versions) on the same weights."""
    cfg = FULL._replace(n_layers=2, dtype=torch.float32)
    params = init_transformer_params(seed, cfg, device=device)
    cpu_params = params_to_device(params, "cpu")
    rng = np.random.default_rng(seed)
    lens = [37, 100, 16]
    tb, slots, n_pages = 128, 4, 64
    pps = paged_kv.pages_per_slot(cfg, PAGE_SIZE)
    toks = np.zeros((slots, tb), np.int32)
    true_len = np.ones((slots,), np.int32)      # row 3 is padding
    page_ids = np.full((slots, tb // PAGE_SIZE), n_pages, np.int32)
    table = np.full((slots, pps), n_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
        true_len[i] = n
        own = list(range(nxt, nxt + paged_kv.pages_for_tokens(n + 8,
                                                              PAGE_SIZE)))
        nxt += len(own)
        page_ids[i, :paged_kv.pages_for_tokens(n, PAGE_SIZE)] = \
            own[:paged_kv.pages_for_tokens(n, PAGE_SIZE)]
        table[i, :len(own)] = own
    steps = rng.integers(0, cfg.vocab_size, (8, slots)).astype(np.int32)
    active = np.array([True, True, True, False])
    results = {}
    for where, dev, p in (("card", device, params),
                          ("cpu", torch.device("cpu"), cpu_params)):
        def t(a, dtype=None):
            x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return x if dtype is None else x.to(dtype)
        pool = paged_kv.init_paged_pool(cfg, n_pages, PAGE_SIZE, device=dev)
        logits, pool = paged_kv.paged_prefill(p, t(toks), t(true_len), pool,
                                              t(page_ids), cfg)
        out = [logits[:3].float().cpu()]
        lengths = np.array(lens + [0], np.int32)
        for s in range(8):
            logits, pool = paged_kv.paged_decode_step(
                p, t(steps[s]), pool, t(table), t(lengths), t(active), cfg,
                kernel="kernel")
            out.append(logits[:3].float().cpu())
            lengths = lengths + active.astype(np.int32)
        results[where] = torch.stack(out)
    torch.cuda.synchronize()
    diff = max_err(results["card"], results["cpu"])
    finite = bool(torch.isfinite(results["card"]).all())
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "prompt_lengths": lens, "decode_steps": 8,
            "logits_max_abs_diff": diff, "logit_scale": float(
                results["cpu"].abs().max()), "finite": finite,
            "ok": finite and diff <= 1e-3}


def serve_requests(seed):
    """Phase 5's prompts: N_REQUESTS lengths in [16, 768], from the seed."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 769, N_REQUESTS).tolist()
    return [rng.integers(0, FULL.vocab_size, n).tolist() for n in plens]


def phase_serve(device, seed):
    params = init_transformer_params(seed, FULL, device=device)
    n_params = count_params(params)
    prompts = serve_requests(seed)
    plens = [len(p) for p in prompts]
    eng = InferenceEngine.for_transformer(params, FULL,
                                          decode_slots=SLOTS,
                                          page_size=PAGE_SIZE,
                                          device=device)
    try:
        loop = eng.decode_loop
        torch.cuda.synchronize()
        graphs_before = loop.graph_launches()
        flash.launches = 0
        paged.launches = 0
        t0 = time.perf_counter()
        streams = [eng.generate_stream(p, MAX_TOKENS) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        launches = loop_launches(loop, graphs_before)
        snap = loop.snapshot()
        steps = sorted(loop.step_seconds)
        # every page back: free, or held by the prefix cache unreferenced
        ok = (all(s.finish_reason == "max_tokens" for s in streams)
              and all(len(o) == MAX_TOKENS for o in outs)
              and all(0 <= t < FULL.vocab_size for o in outs for t in o)
              and snap["pages_in_use"] == 0 and page_balance(loop)
              and launches["flash_fwd"] > 0 and launches["paged_decode"] > 0
              and snap["decode_kernel"]["selected"] == "kernel"
              and snap["decode_step_programs"] == 1)
        # the engine's other entry point: per-request KV-cached generate
        gen_out = eng.generate(np.array([prompts[0][:32]]), 8)
        ok = ok and gen_out.shape == (1, 40)
    finally:
        eng.close()
    generated = sum(len(o) for o in outs)
    return {"params": n_params, "layers": FULL.n_layers,
            "d_model": FULL.d_model, "heads": FULL.n_heads,
            "vocab": FULL.vocab_size, "dtype": "bfloat16",
            "slots": SLOTS, "page_size": PAGE_SIZE,
            "n_pages": loop.n_pages, "requests": N_REQUESTS,
            "prompt_lengths": plens, "max_tokens": MAX_TOKENS,
            "generated_tokens": generated, "wall_s": wall,
            "tokens_per_s": generated / wall,
            "decode_steps": len(steps),
            "decode_step_ms_p50": steps[len(steps) // 2] * 1e3,
            "decode_step_ms_mean": sum(steps) / len(steps) * 1e3,
            "prefill_groups": snap["prefill_groups"],
            "prefix_cache": snap["prefix_cache"],
            "decode_graphs": snap["decode_graphs"],
            "launches": launches, "peak_pages_in_use":
                snap["peak_pages_in_use"], "ok": ok}, params, plens


# --------------------------------------------------- serving features
#: the serve_features phase: 16 requests sharing a 256-token head (16
#: pages) with tails of 16-256 tokens, SF_NEW tokens each; the model
#: drafter (2 layers, d 512, hd 128) on the target's vocabulary
SF_PAGES, SF_HEAD, SF_TAIL, SF_NEW = 512, 256, (16, 256), 32
SF_HORIZON, SF_NGRAM_K, SF_MODEL_K, SF_WAVES = 8, 4, 3, 3
DRAFT = TransformerConfig(vocab_size=FULL.vocab_size, d_model=512,
                          n_heads=4, n_layers=2, d_ff=2048,
                          max_len=FULL.max_len, dtype=torch.bfloat16)
#: serve_features_parity: a first token difference is forgiven when the
#: reference's top-2 logit gap there is below this (float32)
GAP_TOL = 1e-3
PROFILE_GROUPS = {"paged_decode": "paged_decode", "cublas_gemm": ("nvjet",
                                                                  "gemm"),
                  "elementwise": "elementwise_kernel"}


def loop_launches(loop, graphs_before) -> dict:
    """One path's kernel launches through a decode loop: the wrappers'
    counts (set to 0 at the path's start) plus what the loop's captured
    graphs launched in their replays since `graphs_before` (its
    graph_launches() at the start)."""
    graphs = loop.graph_launches()
    return {name: mod.launches + graphs[name] - graphs_before[name]
            for name, mod in (("paged_decode", paged), ("flash_fwd", flash))}


def page_balance(loop) -> bool:
    """free + in use + cached-unreferenced == n_pages."""
    return (len(loop._free) + loop.pages_in_use + loop._cached_unref()
            == loop.n_pages)


def drive(loop, streams, max_ticks=100_000):
    """Tick a `start=False` loop until idle, checking the page invariant
    after every tick; (wall s, each stream's time to first token in ms
    from the drive's start, ticks whose invariant failed)."""
    ttft = [None] * len(streams)
    bad = 0
    t0 = time.perf_counter()
    for _ in range(max_ticks):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                break
        loop.tick()
        now = time.perf_counter()
        bad += not page_balance(loop)
        for i, s in enumerate(streams):
            if ttft[i] is None and s._generated:
                ttft[i] = (now - t0) * 1e3
    else:
        raise AssertionError("decode loop did not drain")
    return time.perf_counter() - t0, ttft, bad


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def feature_loop(params, cfg, device, **kw):
    """A manually ticked decode loop behind the engine's entry point."""
    kw.setdefault("page_size", PAGE_SIZE)
    eng = InferenceEngine.for_transformer(params, cfg, decode_slots=SLOTS,
                                          device=device, start=False, **kw)
    return eng.decode_loop


def run_requests(loop, prompts, max_tokens, **submit_kw):
    """One path: the kernel counts set to 0, every prompt submitted at
    once, the loop driven to idle, the counts read. The streams' tokens
    and the run's numbers."""
    before = loop.snapshot()
    graphs_before = loop.graph_launches()
    paged.launches = flash.launches = 0
    streams = [loop.submit(p, max_tokens, **submit_kw) for p in prompts]
    wall, ttft, bad = drive(loop, streams)
    launches = loop_launches(loop, graphs_before)
    snap = loop.snapshot()
    n = snap["dispatches"] - before["dispatches"]
    steps = sorted(list(loop.step_seconds)[-n:]) if n else []
    generated = sum(len(s._generated) for s in streams)
    return [s.result(0) for s in streams], {
        "wall_s": wall, "generated_tokens": generated,
        "tokens_per_s": generated / wall, "dispatches": n,
        # decode tokens (all but the prefill firsts) a dispatch delivered
        "tokens_per_dispatch": (generated - len(streams)) / max(n, 1),
        "dispatch_ms_p50": pct(steps, 0.5) * 1e3 if steps else None,
        "ttft_ms": ttft, "ttft_ms_p50": pct(ttft, 0.5),
        "prefill_tokens": snap["prefill_tokens"] - before["prefill_tokens"],
        "prefix": {k: snap["prefix_cache"][k] - before["prefix_cache"][k]
                   for k in ("hits", "misses", "forks", "evictions")},
        "launches": launches,
        "reasons": sorted({s.finish_reason for s in streams}),
        "invariant_failed_ticks": bad}


def warm_up(loop):
    """Capture the loop's graphs before a measured run: one request
    whose prompt repeats (so the ngram drafter proposes), outside the
    prefix cache."""
    drive(loop, [loop.submit([5, 6, 7] * 6, 8, prefix_cache=False)])


def replay_timing(loop, timer, name):
    """One captured graph replayed with every slot idle (its writes go to
    the trash page): device ms by CUDA events (`Timer.ms`), and the host
    ms until `replay()` returns (p50 of 10)."""
    loop._d_stop.zero_()
    if name == "verify":
        loop._verify_views(loop._vd_ctrl)[2].zero_()
    loop._dirty = True
    graph = loop._graphs[name].graph
    device_ms = timer.ms(graph.replay)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        graph.replay()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return {"replay_ms": device_ms, "launch_host_ms": pct(host, 0.5) * 1e3,
            "capture_ms": loop._graphs[name].capture_ms}


def steady_profile(loop, seed, iters=8):
    """The device's busy share over `iters` ticks of a full loop in steady
    decode (8 slots, prompts of 128 tokens), then drain."""
    rng = np.random.default_rng(seed)
    streams = [loop.submit(rng.integers(0, FULL.vocab_size, 128).tolist(),
                           (iters + 4) * loop.horizon) for _ in range(SLOTS)]
    for _ in range(3):
        loop.tick()
    prof = device_profile(loop.tick, iters=iters, groups=PROFILE_GROUPS)
    for s in streams:
        s.cancel()
    drive(loop, [])
    return prof


def first_differences(params, cfg, prompts, outs_a, outs_b) -> list:
    """The first difference of EVERY stream on which the two runs differ
    (empty when they agree): its position, both tokens, the reference's
    top-2 logit gap there and how far below the reference's top logit
    each run's token lies. The reference is transformer_logits over the
    prompt and the tokens both runs share."""
    diffs = []
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        seq = torch.tensor([list(prompts[i]) + a[:j]], dtype=torch.int32,
                           device=params["embed"].device)
        with torch.no_grad():
            logits = transformer_logits(params, seq, cfg)[0, -1].float()
        diffs.append(near_tie_record(i, j, logits, [
            a[j] if j < len(a) else None, b[j] if j < len(b) else None]))
    return diffs


def near_tie_record(row, position, logits, tokens) -> dict:
    top = torch.topk(logits, 2).values
    return {"stream": row, "position": position, "tokens": tokens,
            "top_logit": float(top[0]), "top2_gap": float(top[0] - top[1]),
            "below_top": [None if t is None else float(top[0] - logits[t])
                          for t in tokens]}


def dtype_step(dtype, value) -> float:
    """The spacing of `dtype`'s values at |value| (one step, or ulp)."""
    return math.ldexp(torch.finfo(dtype).eps, math.frexp(abs(value))[1] - 1)


def near_ties(diffs, tol, rounded_in=None) -> bool:
    """Every first difference is a rounding near-tie: each run's token
    lies within `tol` of the reference's top logit there. With
    `rounded_in` (the logits' dtype) for two runs whose arithmetic
    differs, also within 2 steps of that dtype at the top logit: both
    runs' logits are rounded to it, half a step each on the two logits
    compared, so output rounding alone moves a pick that far."""
    def allowed(d):
        return (tol if rounded_in is None
                else max(tol, 2 * dtype_step(rounded_in, d["top_logit"])))
    return all(x is None or x <= allowed(d)
               for d in diffs for x in d["below_top"])


def record_windows(drafter, keep=4) -> list:
    """Count the model drafter's K1 launches and keep the first `keep`
    (S, window) batches it is given: wraps `propose_all` in place.
    Returns [K1 launches, propose_all calls, windows]."""
    rec = [0, 0, []]
    propose = drafter.propose_all

    def counted(windows, k):
        before = flash.launches
        res = propose(windows, k)
        rec[0] += flash.launches - before
        rec[1] += 1
        if len(rec[2]) < keep:
            rec[2].append(np.array(windows, copy=True))
        return res

    drafter.propose_all = counted
    return rec


@contextlib.contextmanager
def attention_as(fn):
    """The transformer's attention (K1's wrapper) replaced by `fn`."""
    orig = transformer_mod.flash_attention
    transformer_mod.flash_attention = fn
    try:
        yield orig
    finally:
        transformer_mod.flash_attention = orig


def drafter_vs_plain(drafter, windows, k, tol) -> dict:
    """The model drafter on the card (K1) against the same drafter with
    K1's plain version in its place, on the windows the path gave it:
    each row's k proposals equal, or its first difference a near-tie of
    the plain run's draft logits (within `tol` of the top). K1 is also
    held against its plain version on the very q, k, v the drafter's
    layers give it: within TOL of its dtype times the largest |plain|
    value. These comparison launches are not counted: the class's own
    propose_all is called, past record_windows' wrapper."""
    err, scale = 0.0, 0.0
    propose = type(drafter).propose_all

    def both(q, k_, v, causal):
        nonlocal err, scale
        out = kernel(q, k_, v, causal)
        ref = flash.flash_attention_ref(q, k_, v, causal)
        err = max(err, max_err(out, ref))
        scale = max(scale, float(ref.abs().max()))
        return out

    def plain(q, k_, v, causal):
        return flash.flash_attention_ref(q, k_, v, causal)

    diffs, rows, shapes = [], 0, set()
    for win in windows:
        with attention_as(both) as kernel:
            got = propose(drafter, win, k)
        with attention_as(plain):
            ref = propose(drafter, win, k)
            for i in range(win.shape[0]):
                rows += 1
                if (got[i] == ref[i]).all():
                    continue
                j = int(np.argmax(got[i] != ref[i]))
                hist = np.concatenate([win[i], ref[i, :j]])[-win.shape[1]:]
                seq = torch.from_numpy(hist[None].astype(np.int32)).to(
                    drafter.device)
                with torch.no_grad():
                    logits = transformer_logits(drafter.params, seq,
                                                drafter.cfg)[0, -1].float()
                diffs.append(near_tie_record(
                    i, j, logits, [int(ref[i, j]), int(got[i, j])]))
        shapes.add(tuple(win.shape))
    dtype = drafter.cfg.dtype
    return {"windows": len(windows), "rows": rows,
            "window_shapes": sorted(shapes),
            "first_differences": diffs,
            "k1_path_max_abs_err": err, "k1_path_max_abs_plain": scale,
            "ok": near_ties(diffs, tol) and err <= TOL[dtype] * scale}


def k1_at_draft_shape(gen, device, drafter, slots) -> dict:
    """K1 against its plain version at the model drafter's attention
    shape (B*H = slots x heads, T = the draft window, causal), on
    unit-scale inputs, within TOL of the drafter's dtype."""
    cfg = drafter.cfg
    bh, t, hd = slots * cfg.n_heads, drafter.window, cfg.d_model // cfg.n_heads
    q, k, v = (torch.randn(bh, t, hd, generator=gen).to(device, cfg.dtype)
               for _ in range(3))
    err = max_err(flash.flash_attention(q, k, v, True),
                  flash.flash_attention_ref(q, k, v, True))
    return {"bh": bh, "tq": t, "tk": t, "hd": hd, "causal": True,
            "dtype": str(cfg.dtype), "max_abs_err": err,
            "ok": err <= TOL[cfg.dtype]}


def phase_serve_features(device, seed, params, timer):
    """The decode loop's serving features at full width: prefix cache,
    horizon + CUDA graph, speculation (ngram and model drafters), SLO
    tiers with preemption."""
    rng = np.random.default_rng(seed + 10)
    out, ok = {}, True
    L = FULL.n_layers
    #: each sub-run's launches: K4 in the verify rounds is "spec", K1 in
    #: the model drafter "draft", everything else "serve_features"
    by_path = {"paged_decode": {"serve_features": 0, "spec": 0},
               "flash_fwd": {"serve_features": 0, "draft": 0}}

    def count(run, spec=False, draft=0):
        by_path["paged_decode"]["spec" if spec else "serve_features"] += \
            run["launches"]["paged_decode"]
        by_path["flash_fwd"]["draft"] += draft
        by_path["flash_fwd"]["serve_features"] += \
            run["launches"]["flash_fwd"] - draft

    # 1. prefix cache: 16 requests on one head, cold and warm
    head = rng.integers(0, FULL.vocab_size, SF_HEAD).tolist()
    tails = rng.integers(SF_TAIL[0], SF_TAIL[1] + 1, N_REQUESTS).tolist()
    prompts = [head + rng.integers(0, FULL.vocab_size, t).tolist()
               for t in tails]
    t_sec = time.perf_counter()
    loop = feature_loop(params, FULL, device, kv_pages=SF_PAGES)
    warm_up(loop)
    # cold (opted out) and warm waves alternate, after one seeding wave
    _, seeding = run_requests(loop, prompts, SF_NEW)
    colds, warms = [], []
    for _ in range(SF_WAVES):
        cold_toks, cold = run_requests(loop, prompts, SF_NEW,
                                       prefix_cache=False)
        warm_toks, warm = run_requests(loop, prompts, SF_NEW)
        colds.append(cold)
        warms.append(warm)
    # a fully covered prompt (the 16 head pages): no prefill, one fork
    _, full = run_requests(loop, [head], SF_NEW)
    runs = [seeding, *colds, *warms, full]
    for run in runs:
        count(run)
    loop_snap = loop.snapshot()
    total = sum(len(p) for p in prompts)
    # the warm tail is prefilled in float32 over the cached pages, the
    # cold prompt by K1 in bf16: tokens may part only at near-ties
    warm_diffs = first_differences(params, FULL, prompts, cold_toks,
                                   warm_toks)
    prefix_ok = (near_ties(warm_diffs, TOL[FULL.dtype], FULL.dtype)
                 and all(c["prefill_tokens"] == total for c in colds)
                 and all(w["prefix"]["hits"] >= N_REQUESTS
                         and w["prefill_tokens"]
                         <= total - N_REQUESTS * SF_HEAD for w in warms)
                 and full["prefix"]["forks"] == 1
                 and full["prefill_tokens"] == 0
                 and all(r["invariant_failed_ticks"] == 0 for r in runs)
                 and loop_snap["pages_in_use"] == 0 and page_balance(loop)
                 and all(r["reasons"] == ["max_tokens"] for r in runs))

    def first_wave(waves):
        # the time to first token of the requests admitted at once
        return [w["ttft_ms"][0] for w in waves]

    out["prefix_cache"] = {
        "requests": N_REQUESTS, "head_tokens": SF_HEAD,
        "tail_tokens": tails, "new_tokens": SF_NEW, "seeding": seeding,
        "cold": colds, "warm": warms, "full_hit": full,
        "first_wave_ttft_ms": {"cold": first_wave(colds),
                               "warm": first_wave(warms)},
        "ttft_ms_p50": {"cold": pct([t for c in colds
                                     for t in c["ttft_ms"]], 0.5),
                        "warm": pct([t for w in warms
                                     for t in w["ttft_ms"]], 0.5)},
        "warm_equal_cold_streams": sum(a == b for a, b in
                                       zip(warm_toks, cold_toks)),
        "warm_first_differences_vs_cold": warm_diffs,
        "pages_cached": loop_snap["prefix_cache"]["pages_cached"],
        "seconds": time.perf_counter() - t_sec, "ok": prefix_ok}
    ok = ok and prefix_ok
    del loop

    # 2. horizon and graph: phase 5's requests, eager h1 / graph h1 /
    # graph h8
    serve_prompts = serve_requests(seed)
    t_sec = time.perf_counter()
    runs, toks = {}, {}
    for name, horizon, capture in (("eager_h1", 1, False),
                                   ("graph_h1", 1, True),
                                   (f"graph_h{SF_HORIZON}", SF_HORIZON,
                                    True)):
        loop = feature_loop(params, FULL, device, horizon=horizon,
                            kv_pages=SF_PAGES)
        loop._capture = capture
        warm_up(loop)
        toks[name], runs[name] = run_requests(loop, serve_prompts,
                                              MAX_TOKENS)
        count(runs[name])
        snap = loop.snapshot()
        runs[name]["decode_step_programs"] = loop.decode_step_programs()
        runs[name]["graph_replays"] = snap["decode_graphs"]["replays"]
        runs[name]["ms_per_token_p50"] = (runs[name]["dispatch_ms_p50"]
                                          / horizon)
        runs[name]["profile"] = steady_profile(loop, seed + 20)
        if capture:
            g = loop._graphs["step"]
            runs[name]["graph_launches_per_replay"] = g.launches
            runs[name]["graph"] = replay_timing(loop, timer, "step")
            ok = ok and g.launches["paged_decode"] == horizon * L
        ok = ok and runs[name]["invariant_failed_ticks"] == 0
        del loop
    diffs = {name: first_differences(params, FULL, serve_prompts,
                                      toks["eager_h1"], toks[name])
             for name in runs if name != "eager_h1"}
    horizon_ok = (all(near_ties(d, TOL[FULL.dtype]) for d in diffs.values())
                  and runs["graph_h1"]["decode_step_programs"] == 1
                  and runs[f"graph_h{SF_HORIZON}"]["decode_step_programs"]
                  == 1)
    out["horizon"] = {"runs": runs, "first_differences_vs_eager": diffs,
                      "seconds": time.perf_counter() - t_sec,
                      "ok": horizon_ok}
    ok = ok and horizon_ok

    # 3. speculation: ngram k=4, then the model drafter k=3
    t_sec = time.perf_counter()
    draft_params = init_transformer_params(seed + 7, DRAFT, device=device)
    spec = {}
    for name, kw in (("ngram", {"speculation": SF_NGRAM_K}),
                     ("model", {"speculation": SF_MODEL_K,
                                "drafter": "model",
                                "draft_params": draft_params,
                                "draft_cfg": DRAFT})):
        loop = feature_loop(params, FULL, device, kv_pages=SF_PAGES, **kw)
        k = kw["speculation"]
        # (K1 launches, propose_all calls, windows kept)
        draft_k1 = (record_windows(loop._drafter) if name == "model"
                    else [0, 0, []])
        warm_up(loop)
        draft_k1[:] = [0, 0, []]
        spec_toks, run = run_requests(loop, serve_prompts, MAX_TOKENS)
        count(run, spec=True, draft=draft_k1[0])
        diffs = first_differences(params, FULL, serve_prompts,
                                  toks["eager_h1"], spec_toks)
        snap = loop.snapshot()
        sp = snap["speculation"]
        graphs = loop._graphs
        verify = graphs.get("verify")
        run.update({
            "k": k, "proposed": sp["proposed"], "accepted": sp["accepted"],
            "rounds": sp["rounds"], "acceptance_rate": sp["acceptance_rate"],
            "decode_step_programs": loop.decode_step_programs(),
            "graph_replays": snap["decode_graphs"]["replays"],
            "verify_k4_per_replay": (verify.launches["paged_decode"]
                                     if verify else 0),
            "equal_to_plain_streams": sum(
                a == b for a, b in zip(spec_toks, toks["eager_h1"])),
            "first_differences_vs_eager": diffs})
        run["verify_graph"] = replay_timing(loop, timer, "verify")
        run["step_graph"] = (replay_timing(loop, timer, "step")
                             if "step" in graphs else None)
        if name == "model":
            run["draft_k1_launches"] = draft_k1[0]
            run["draft_calls"] = draft_k1[1]
            run["drafter_vs_plain"] = drafter_vs_plain(
                loop._drafter, draft_k1[2], k, TOL[DRAFT.dtype])
            run["draft_k1_check"] = k1_at_draft_shape(
                torch.Generator().manual_seed(seed), device, loop._drafter,
                SLOTS)
            ok = (ok and draft_k1[0] == draft_k1[1] * k * DRAFT.n_layers > 0
                  and len(draft_k1[2]) > 0
                  and run["drafter_vs_plain"]["ok"]
                  and run["draft_k1_check"]["ok"])
        ok = (ok and verify is not None
              and near_ties(diffs, TOL[FULL.dtype], FULL.dtype)
              and verify.launches["paged_decode"] == (k + 1) * L
              and run["decode_step_programs"] == 2
              and run["invariant_failed_ticks"] == 0
              and run["reasons"] == ["max_tokens"])
        spec[name] = run
        del loop
    spec["seconds"] = time.perf_counter() - t_sec
    out["speculation"] = spec
    del draft_params

    # 4. SLO tiers: batch holds every slot, then interactive arrivals
    t_sec = time.perf_counter()
    loop = feature_loop(params, FULL, device, kv_pages=SF_PAGES)
    warm_up(loop)
    graphs_before = loop.graph_launches()
    paged.launches = flash.launches = 0
    batch = [loop.submit(rng.integers(0, FULL.vocab_size, 64).tolist(),
                         256, tier="batch") for _ in range(SLOTS)]
    for _ in range(4):
        loop.tick()
    held = loop.snapshot()["tiers"]["occupied"]["batch"]
    inter = [loop.submit(rng.integers(0, FULL.vocab_size, 48).tolist(), 16)
             for _ in range(4)]
    wall, ttft, bad = drive(loop, batch + inter)
    count({"launches": loop_launches(loop, graphs_before)})
    snap = loop.snapshot()
    reasons = [s.finish_reason for s in batch]
    tiers_ok = (held == SLOTS and reasons.count("preempted") >= 1
                and all(s.finish_reason == "max_tokens" for s in inter)
                and bad == 0 and snap["pages_in_use"] == 0
                and page_balance(loop))
    out["tiers"] = {"batch_held_before": held,
                    "batch_reasons": reasons,
                    "interactive_reasons": [s.finish_reason for s in inter],
                    "interactive_ttft_ms": ttft[SLOTS:],
                    "preemptions": snap["tiers"]["preemptions"],
                    "wall_s": wall, "invariant_failed_ticks": bad,
                    "seconds": time.perf_counter() - t_sec,
                    "ok": tiers_ok}
    ok = ok and tiers_ok
    del loop
    out["launches_by_path"] = by_path
    out["ok"] = ok
    return out


def phase_serve_features_parity(device, seed):
    """The parity phase's width (2 layers, float32) on the card: warm
    against cold prefix, speculative (ngram, and the model drafter)
    against plain, horizon 4 against horizon 1 give identical tokens (a
    stream's first difference is forgiven where both tokens lie within
    GAP_TOL of the top logit); the model drafter's proposals with K1
    against K1's plain version the same way; paged_verify_step held
    column by column against paged_decode_step's logits within 1e-3."""
    cfg = FULL._replace(n_layers=2, dtype=torch.float32)
    params = init_transformer_params(seed, cfg, device=device)
    rng = np.random.default_rng(seed + 30)
    head = rng.integers(0, cfg.vocab_size, 64).tolist()
    prompts = [head + rng.integers(0, cfg.vocab_size, t).tolist()
               for t in (5, 37, 64, 90)]
    n_new = 24

    def run(**kw):
        loop = feature_loop(params, cfg, device, **kw)
        outs, rec = run_requests(loop, prompts, n_new)
        ok = rec["invariant_failed_ticks"] == 0
        return loop, outs, rec, ok

    _, plain, _, ok = run(prefix_cache=False)
    loop, _, _, ok_s = run()
    warm, warm_rec = run_requests(loop, prompts, n_new)
    ok = ok and ok_s and warm_rec["prefix"]["hits"] == len(prompts)
    _, spec, spec_rec, ok_p = run(speculation=4)
    _, h4, _, ok_h = run(horizon=4)
    dcfg = DRAFT._replace(dtype=torch.float32)
    dloop = feature_loop(params, cfg, device, speculation=3,
                         drafter="model", draft_cfg=dcfg,
                         draft_params=init_transformer_params(
                             seed + 7, dcfg, device=device))
    windows = record_windows(dloop._drafter)
    model_spec, model_rec = run_requests(dloop, prompts, n_new)
    drafter = drafter_vs_plain(dloop._drafter, windows[2], 3, GAP_TOL)
    ok = (ok and ok_p and ok_h and model_rec["invariant_failed_ticks"] == 0
          and windows[0] > 0 and drafter["ok"])
    diffs = {name: first_differences(params, cfg, prompts, plain, other)
             for name, other in (("warm", warm), ("speculative", spec),
                                 ("model_speculative", model_spec),
                                 ("horizon4", h4))}
    ok = ok and all(near_ties(d, GAP_TOL) for d in diffs.values())

    # verify step column by column against chained decode steps (K4)
    W, n_pages = 5, 64
    pps = paged_kv.pages_per_slot(cfg, PAGE_SIZE)
    lens = [37, 100, 16, 250]
    table = np.full((4, pps), n_pages, np.int32)
    pos = 0
    for i, n in enumerate(lens):
        need = paged_kv.pages_for_tokens(n + W, PAGE_SIZE)
        table[i, :need] = range(pos, pos + need)
        pos += need
    tokens = rng.integers(0, cfg.vocab_size, (4, W)).astype(np.int32)
    widths = np.array([W, 1, 3, W], np.int32)
    g = torch.Generator().manual_seed(seed)

    def fresh_pool():
        pool = paged_kv.init_paged_pool(cfg, n_pages, PAGE_SIZE,
                                        device=device)
        for layer in pool.layers:
            for name in ("k", "v"):
                layer[name].copy_(torch.randn(layer[name].shape,
                                              generator=g).to(device))
        return pool

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pool_a = fresh_pool()
    g.manual_seed(seed)
    pool_b = fresh_pool()
    vlog, _ = paged_kv.paged_verify_step(params, t(tokens), pool_a, t(table),
                                         t(np.array(lens, np.int32)),
                                         t(widths), cfg, kernel="kernel")
    cur = np.array(lens, np.int32)
    verify_err = 0.0
    for j in range(W):
        act = widths > j
        dlog, _ = paged_kv.paged_decode_step(
            params, t(tokens[:, j]), pool_b, t(table), t(cur), t(act), cfg,
            kernel="kernel")
        for i in range(4):
            if act[i]:
                verify_err = max(verify_err, max_err(vlog[i, j], dlog[i]))
        cur = cur + act.astype(np.int32)
    ok = ok and verify_err <= 1e-3
    return {"layers": cfg.n_layers, "dtype": "float32",
            "prompt_lengths": [len(p) for p in prompts], "new_tokens": n_new,
            "first_differences_vs_plain": diffs,
            "warm_hits": warm_rec["prefix"]["hits"],
            "speculative_dispatches": spec_rec["dispatches"],
            "model_speculative_dispatches": model_rec["dispatches"],
            "draft_k1_launches": windows[0], "drafter_vs_plain": drafter,
            "verify_vs_decode_max_abs_err": verify_err,
            "verify_widths": widths.tolist(), "ok": ok}


# ------------------------------------------------ the HTTP front end
#: the http_serve phase: /predict rows from concurrent clients, rows a
#: request, the batcher's coalescing cap; the streamed share of phase 5's
#: /generate requests; the arrival stagger of the ordered round and how
#: long its first scheduler pass waits for every request to queue
HTTP_ROWS, HTTP_CLIENTS, HTTP_ROWS_PER_REQ, HTTP_BATCH = 2048, 8, 32, 256
HTTP_STAGGER_S, HTTP_HOLD_S = 0.03, 1.0
#: the keys of the JAX CLI's `serve` announce line (its cli.py:502-545)
ANNOUNCE_KEYS = {
    "serving", "role", "model_id", "replicas", "max_batch_size",
    "max_delay_ms", "slots", "page_size", "prefix_cache", "decode_kernel",
    "decode", "compile_cache", "warmup_plan", "metrics"}
ANNOUNCE_DECODE_KEYS = {"kernel", "prefix_cache", "fleet_kv", "slots",
                        "batch_share", "page_size", "kv_pages", "horizon",
                        "speculation"}
HTTP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_http"
#: /generate clients in a process of their own (stdlib only): argv is the
#: server's URL, the prompts, max_tokens and the streamed rows (JSON);
#: prints {"wall_s", "rows": [[tokens, ms to the first token], ...]}
CLIENT_PROCESS = r"""
import json, sys, threading, time, urllib.request
url, prompts, n = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
streamed = set(json.loads(sys.argv[4]))
rows = [None] * len(prompts)
def run(i):
    body = {"prompt": [prompts[i]], "max_tokens": n,
            "stream": i in streamed, "prefix_cache": False}
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0, first, toks = time.perf_counter(), None, None
    with urllib.request.urlopen(req, timeout=600) as r:
        if i not in streamed:
            toks = json.loads(r.read())["tokens"][0][len(prompts[i]):]
        for line in (r if i in streamed else ()):
            ev = json.loads(line)
            if "token" in ev and first is None:
                first = (time.perf_counter() - t0) * 1e3
            if ev.get("done"):
                toks = ev["tokens"][0][len(prompts[i]):]
    rows[i] = [toks, first]
t0 = time.perf_counter()
threads = [threading.Thread(target=run, args=(i,))
           for i in range(len(prompts))]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"wall_s": time.perf_counter() - t0, "rows": rows}))
"""


def http_post(url, payload, timeout=600):
    from urllib import request

    req = request.Request(url, data=json.dumps(payload).encode(),
                          headers={"Content-Type": "application/json"})
    with request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_get(url, timeout=60):
    from urllib import request

    with request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def http_generate(url, prompt, max_tokens, stream, **body):
    """One /generate row over HTTP: (generated tokens, ms to the first
    streamed token or None, ms to the reply's end)."""
    from urllib import request

    payload = {"prompt": [prompt], "max_tokens": max_tokens,
               "stream": stream, **body}
    req = request.Request(url + "/generate",
                          data=json.dumps(payload).encode(),
                          headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    with request.urlopen(req, timeout=600) as r:
        if not stream:
            out = json.loads(r.read())
            return (out["tokens"][0][len(prompt):], None,
                    (time.perf_counter() - t0) * 1e3)
        while True:
            line = r.readline()
            if not line:
                break
            event = json.loads(line)
            if "token" in event and first is None:
                first = (time.perf_counter() - t0) * 1e3
            if event.get("done"):
                toks = event["tokens"][0][len(prompt):]
            if "error" in event:
                raise RuntimeError(f"stream failed: {event}")
    return toks, first, (time.perf_counter() - t0) * 1e3


def clients_in_a_process(url, prompts, streamed):
    """Phase 5's requests at once from clients in a process of their own
    (CLIENT_PROCESS, outside the prefix cache): (wall s, [(tokens, ms to
    the first streamed token or None)])."""
    sub = subprocess.run(
        [sys.executable, "-c", CLIENT_PROCESS, url, json.dumps(prompts),
         str(MAX_TOKENS), json.dumps(sorted(streamed))],
        capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    rec = json.loads(sub.stdout)
    return rec["wall_s"], [tuple(r) for r in rec["rows"]]


def concurrently(fns):
    """Run each callable on its own thread; their results in order (an
    exception in any is raised here)."""
    import threading

    results = [None] * len(fns)
    errors = []

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    return results


def in_process_reference(params, prompts, device):
    """Phase 5's requests through an in-process DecodeLoop of the http
    server's configuration, every prompt submitted as one group (so all
    queue before the first admission): the tokens, tokens/s and each
    stream's time to first token (ms from the submit)."""
    from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop

    loop = DecodeLoop(params, FULL, slots=SLOTS, page_size=PAGE_SIZE,
                      n_pages=SF_PAGES, device=device)
    try:
        # the step graph captured and the prefill shapes run once
        # (outside the prefix cache), as the timed HTTP round finds the
        # server's
        for s in loop.submit_many(prompts, MAX_TOKENS, prefix_cache=False):
            s.result(600)
        n0 = loop.snapshot()["dispatches"]
        t0 = time.perf_counter()
        streams = loop.submit_many(prompts, MAX_TOKENS)
        firsts = [None] * len(streams)
        while not all(s.done for s in streams):
            now = (time.perf_counter() - t0) * 1e3
            for i, s in enumerate(streams):
                if firsts[i] is None and s._generated:
                    firsts[i] = now
            time.sleep(0.0005)
        wall = time.perf_counter() - t0
        outs = [s.result(0) for s in streams]
        n = loop.snapshot()["dispatches"] - n0
        steps = sorted(list(loop.step_seconds)[-n:])
    finally:
        loop.close()
    generated = sum(len(o) for o in outs)
    return outs, {"wall_s": wall, "tokens_per_s": generated / wall,
                  "ttft_ms": firsts, "ttft_ms_p50": pct(firsts, 0.5),
                  "dispatches": n, "wall_ms_a_dispatch": wall * 1e3 / n,
                  "dispatch_ms_p50": pct(steps, 0.5) * 1e3}


def phase_http_serve(device, seed, params, timer):
    """`serve_network` in-process at full width: /predict with BASELINE
    config 1's MLP (bf16 products) through ReplicaSet and MicroBatcher,
    /generate with the 110M bf16 LM (8 slots, page_size 16, 512 pages),
    driven by concurrent HTTP clients; then `cli serve --smoke` as a
    subprocess."""
    from deeplearning4j_tpu_torch.serving import serve_network
    from deeplearning4j_tpu_torch.testing import chaos

    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    gen = InferenceEngine.for_transformer(params, FULL, device=device)
    handle = serve_network(net, generate_engine=gen, slots=SLOTS,
                           page_size=PAGE_SIZE, kv_pages=SF_PAGES,
                           max_batch_size=HTTP_BATCH, max_delay_ms=2.0,
                           warmup_shape=(784,))
    out, ok = {"card": nvidia_smi()}, True
    try:
        loop = gen.decode_loop
        url = handle.url
        status, body = http_get(url + "/readyz")
        ready = json.loads(body)
        out["readyz"] = {"status": status, "ready": ready["ready"],
                         "warmup_seconds": ready.get("warmup_seconds")}
        ok = ok and status == 200 and ready["ready"]

        # /predict: 2,048 rows from 8 clients against net.output
        rng = np.random.default_rng(seed + 40)
        x = np.round(rng.uniform(size=(HTTP_ROWS, 784)), 3).astype(
            np.float32)
        with torch.no_grad():
            ref = net.output(torch.from_numpy(x).to(device)).float().cpu()
        per_client = HTTP_ROWS // HTTP_CLIENTS
        lat, errs = [], []

        def client(c):
            got = []
            for r0 in range(c * per_client, (c + 1) * per_client,
                            HTTP_ROWS_PER_REQ):
                rows = x[r0:r0 + HTTP_ROWS_PER_REQ]
                t0 = time.perf_counter()
                res = http_post(url + "/predict", {"inputs": rows.tolist()})
                lat.append((time.perf_counter() - t0) * 1e3)
                got.append((r0, np.asarray(res["outputs"], np.float32)))
            return got

        t0 = time.perf_counter()
        for got in concurrently([lambda c=c: client(c)
                                 for c in range(HTTP_CLIENTS)]):
            for r0, o in got:
                errs.append(max_err(torch.from_numpy(o),
                                    ref[r0:r0 + len(o)]))
        predict_wall = time.perf_counter() - t0
        batcher = handle.batcher.snapshot()
        out["predict"] = {
            "rows": HTTP_ROWS, "clients": HTTP_CLIENTS,
            "rows_per_request": HTTP_ROWS_PER_REQ, "requests": len(lat),
            "latency_ms_p50": pct(lat, 0.5), "latency_ms_p99": pct(lat, 0.99),
            "rows_per_s": HTTP_ROWS / predict_wall,
            "max_abs_err_vs_output": max(errs),
            "batcher_mean_rows_per_batch": batcher["mean_rows_per_batch"],
            "batcher_batches": batcher["batches"]}
        ok = ok and max(errs) <= TOL[torch.bfloat16]

        # /generate: the in-process loop first (its own pool), then the
        # same prompts over HTTP, half of them streamed
        prompts = serve_requests(seed)
        ref_toks, ref_rec = in_process_reference(params, prompts, device)
        streamed = list(range(0, N_REQUESTS, 2))
        graphs_before = loop.graph_launches()
        paged.launches = flash.launches = 0

        def request(i, delay=0.0, **body):
            time.sleep(delay)
            return http_generate(url, prompts[i], MAX_TOKENS,
                                 i in streamed, **body)

        # ordered round: arrivals staggered in request order while the
        # scheduler's first pass holds, so admission (and so every
        # prefill group) is the in-process loop's: tokens equal
        chaos.configure([chaos.Rule("decode.step", "delay",
                                    delay_s=HTTP_HOLD_S, at=[0])])
        try:
            ordered = concurrently([
                lambda i=i: request(i, delay=i * HTTP_STAGGER_S)
                for i in range(N_REQUESTS)])
        finally:
            chaos.deactivate()
        ordered_toks = [o[0] for o in ordered]
        def timed_round(run):
            """One timed round (`run()` -> (wall s, [(tokens, ttft ms)])):
            tokens/s, TTFT p50, and the loop's dispatches and dispatch
            ms p50 (replay through the token copy) in it."""
            n0 = loop.snapshot()["dispatches"]
            wall, res = run()
            n = loop.snapshot()["dispatches"] - n0
            steps = sorted(list(loop.step_seconds)[-n:]) if n else []
            v_ttft = [o[1] for o in res if o[1] is not None]
            return [o[0] for o in res], {
                "wall_s": wall,
                "tokens_per_s": sum(len(o[0]) for o in res) / wall,
                "ttft_ms": v_ttft,
                "ttft_ms_p50": pct(v_ttft, 0.5) if v_ttft else None,
                "dispatches": n, "wall_ms_a_dispatch": wall * 1e3 / max(n, 1),
                "dispatch_ms_p50": pct(steps, 0.5) * 1e3 if steps else None,
                "equal_in_process": sum(o[0] == r for o, r in
                                        zip(res, ref_toks))}

        def in_threads(stream=True, switch=None):
            def run():
                old = sys.getswitchinterval()
                if switch:
                    sys.setswitchinterval(switch)
                try:
                    t0 = time.perf_counter()
                    res = concurrently([
                        lambda i=i: http_generate(
                            url, prompts[i], MAX_TOKENS,
                            stream and i in streamed, prefix_cache=False)
                        for i in range(N_REQUESTS)])
                    return time.perf_counter() - t0, res
                finally:
                    sys.setswitchinterval(old)
            return run

        def in_a_process():
            return clients_in_a_process(url, prompts, streamed)

        # timed round: all clients at once, outside the prefix cache
        timed_toks, timed_rec = timed_round(in_threads())
        torch.cuda.synchronize()
        launches = loop_launches(loop, graphs_before)
        # where HTTP's time goes: the same round with no row streamed,
        # with the interpreter's thread switch interval at 0.1 ms (5 ms
        # by default), and with the clients in a process of their own
        # (so only the server's threads share this interpreter's GIL)
        variants = {}
        for name, run in (("unstreamed", in_threads(stream=False)),
                          ("switch_100us", in_threads(switch=1e-4)),
                          ("clients_in_a_process", in_a_process)):
            variants[name] = timed_round(run)[1]
        diffs = first_differences(params, FULL, prompts, ref_toks,
                                  timed_toks)
        out["generate"] = {
            "requests": N_REQUESTS, "streamed": len(streamed),
            "max_tokens": MAX_TOKENS,
            "ordered_equal_in_process": sum(
                a == b for a, b in zip(ordered_toks, ref_toks)),
            "timed_equal_in_process": sum(
                a == b for a, b in zip(timed_toks, ref_toks)),
            "timed_first_differences": diffs,
            "http": timed_rec,
            "http_variants": variants,
            "in_process": {**ref_rec, "ttft_ms_streamed_p50": pct(
                [ref_rec["ttft_ms"][i] for i in streamed], 0.5)},
            "launches": launches}
        ok = (ok and ordered_toks == ref_toks
              and near_ties(diffs, TOL[FULL.dtype])
              and launches["flash_fwd"] > 0 and launches["paged_decode"] > 0)

        status, metrics = http_get(url + "/metrics")
        metrics = metrics.decode()
        stats = json.loads(http_get(url + "/stats")[1])
        snap = loop.snapshot()
        out["metrics"] = {
            "series": len(metrics.splitlines()),
            "decode_series": sorted({
                ln.split("{")[0].split(" ")[0] for ln in metrics.splitlines()
                if ln.startswith("dl4j_decode_")}),
            "device_memory_bytes": [ln for ln in metrics.splitlines()
                                    if ln.startswith(
                                        'dl4j_device_memory_bytes{device='
                                        '"cuda:0"')]}
        out["warmup"] = stats["warmup"]
        out["decode"] = {k: snap[k] for k in (
            "pages_in_use", "prefill_tokens", "dispatches",
            "decode_step_programs", "prefix_cache", "fleet_kv")}
        ok = (ok and status == 200
              and len(out["metrics"]["decode_series"]) >= 5
              and len(out["metrics"]["device_memory_bytes"]) == 3
              and stats["warmup"]["recompiled_after_warmup"] is not None
              and snap["pages_in_use"] == 0 and page_balance(loop)
              and snap["decode_step_programs"] == 1)
    finally:
        handle.close()

    # the command line on the card, as a subprocess
    shutil.rmtree(HTTP_DIR, ignore_errors=True)
    HTTP_DIR.mkdir(parents=True)
    (HTTP_DIR / "conf.json").write_text(mlp_conf("bfloat16").to_json())
    spec = json.dumps({"vocab_size": FULL.vocab_size, "d_model": 1024,
                       "n_heads": 8, "n_layers": 2, "d_ff": 4096,
                       "max_len": FULL.max_len, "dtype": "bfloat16"})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "-m", str(HTTP_DIR / "conf.json"), "--transformer", spec,
         "--page-size", str(PAGE_SIZE), "--smoke"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(Path(__file__).resolve().parent))
    shutil.rmtree(HTTP_DIR, ignore_errors=True)
    announce = last_json(sub.stdout) if sub.returncode == 0 else {}
    out["cli_serve_smoke"] = {
        "rc": sub.returncode, "seconds": time.perf_counter() - t0,
        "announce": announce, "stderr_tail": sub.stderr[-400:]}
    ok = (ok and sub.returncode == 0 and set(announce) == ANNOUNCE_KEYS
          and set(announce["decode"]) == ANNOUNCE_DECODE_KEYS
          and announce["decode"]["kernel"]["selected"] == "kernel")
    out["ok"] = ok
    return out


# ------------------------------------------- disaggregated prefill/decode
def disagg_prompts(seed):
    """The disagg phase's traffic: 16 prompts on one 256-token head with
    tails of 16-256 tokens, and a lone prompt nobody caches."""
    rng = np.random.default_rng(seed + 50)
    head = rng.integers(0, FULL.vocab_size, SF_HEAD).tolist()
    tails = rng.integers(SF_TAIL[0], SF_TAIL[1] + 1, N_REQUESTS).tolist()
    prompts = [head + rng.integers(0, FULL.vocab_size, t).tolist()
               for t in tails]
    lone = rng.integers(0, FULL.vocab_size, SF_HEAD + 40).tolist()
    return prompts, tails, lone


def phase_disagg(device, seed, params, timer, shared):
    """Three servers on the one card, each fleet_kv "on": role prefill,
    role decode and unified. 16 prompts on a 256-token head (serve_features'
    chat traffic): /prefill on the prefill server, then /generate on the
    decode server naming it as kv_donor. The same prompts on the unified
    server cold (outside the prefix cache) and warm (its own /prefill,
    then /generate). The handoff tokens go to `shared["disagg_handoff"]`
    for the fleet phase's router-driven handoff."""
    from deeplearning4j_tpu_torch.serving import ReplicaSet, serve_network
    from deeplearning4j_tpu_torch.testing import chaos

    prompts, tails, lone = disagg_prompts(seed)
    predict = ReplicaSet([InferenceEngine.for_network(
        MultiLayerNetwork(mlp_conf("bfloat16"), device=device))])
    handles, loops = {}, {}
    for role in ("prefill", "decode", "unified"):
        gen = InferenceEngine.for_transformer(params, FULL, device=device)
        handles[role] = serve_network(
            replicas=predict, generate_engine=gen, slots=SLOTS,
            page_size=PAGE_SIZE, kv_pages=SF_PAGES, fleet_kv="on",
            kv_ship_timeout=60.0, role=role)
        loops[role] = gen.decode_loop
    urls = {r: h.url for r, h in handles.items()}
    ships = []
    dec = loops["decode"]
    ship = dec.kv_ship

    def timed_ship(*a, **kw):
        t0 = time.perf_counter()
        n = ship(*a, **kw)
        ships.append(((time.perf_counter() - t0) * 1e3, n))
        return n

    dec.kv_ship = timed_ship  # the handler looks it up on the loop
    out, ok = {"card": nvidia_smi()}, True
    try:
        # capture the decode and unified servers' step graphs first,
        # outside the prefix cache, so no TTFT below holds a capture
        for role in ("decode", "unified"):
            http_generate(urls[role], lone[:24], 4, False,
                          prefix_cache=False)
        # handoffs: /prefill then the decode server's stream, per prompt
        before = {r: loops[r].snapshot() for r in loops}
        graphs_before = {r: loops[r].graph_launches() for r in loops}
        paged.launches = flash.launches = 0
        handoff, handoff_ttft = [], []
        for p in prompts:
            # the handoff's time to first token: /prefill, then the
            # decode server's first streamed token
            t0 = time.perf_counter()
            http_post(urls["prefill"] + "/prefill", {"prompt": [p]})
            lead = (time.perf_counter() - t0) * 1e3
            toks, first, _ = http_generate(urls["decode"], p, MAX_TOKENS,
                                           True, kv_donor=urls["prefill"])
            handoff.append(toks)
            handoff_ttft.append(lead + first)
        torch.cuda.synchronize()
        k1_prefill_role = flash.launches
        k4_decode_role = (paged.launches
                          + dec.graph_launches()["paged_decode"]
                          - graphs_before["decode"]["paged_decode"])
        pre_snap, dec_snap = (loops["prefill"].snapshot(),
                              dec.snapshot())
        # the shipped pages are the donor's, read back from both pools
        pages_equal = True
        for p in prompts:
            dpages = loops["prefill"]._prefix.match(p)
            rpages = dec._prefix.match(p)
            pages_equal = pages_equal and len(dpages) == len(rpages) == \
                len(p) // PAGE_SIZE
            for dl, rl in zip(loops["prefill"]._pool.layers,
                              dec._pool.layers):
                for name in ("k", "v"):
                    pages_equal = pages_equal and torch.equal(
                        dl[name][dpages], rl[name][rpages])
        tail_tokens = sum(len(p) % PAGE_SIZE for p in prompts)
        # the unified server: cold, then warm through its own /prefill
        cold, cold_ttft, warm = [], [], []
        for p in prompts:
            toks, first, _ = http_generate(urls["unified"], p, MAX_TOKENS,
                                           True, prefix_cache=False)
            cold.append(toks)
            cold_ttft.append(first)
        for p in prompts:
            http_post(urls["unified"] + "/prefill", {"prompt": [p]})
            warm.append(http_generate(urls["unified"], p, MAX_TOKENS,
                                      False)[0])
        cold_diffs = first_differences(params, FULL, prompts, cold, handoff)
        # a chaos fleet.kv_ship error: the decode server falls back to a
        # plain (cold) prefill of a prompt nobody cached — the unified
        # server's cold tokens
        fails = dec.snapshot()["fleet_kv"]["ship_failures"]
        http_post(urls["prefill"] + "/prefill", {"prompt": [lone]})
        chaos.configure([chaos.Rule("fleet.kv_ship", "error", at=[0])])
        try:
            fallback = http_generate(urls["decode"], lone, MAX_TOKENS, False,
                                     kv_donor=urls["prefill"])[0]
        finally:
            chaos.deactivate()
        lone_cold = http_generate(urls["unified"], lone, MAX_TOKENS, False,
                                  prefix_cache=False)[0]
        end = {r: loops[r].snapshot() for r in loops}
        ship_bytes = dec_snap["fleet_kv"]["ship_bytes"] - \
            before["decode"]["fleet_kv"]["ship_bytes"]
        shipped = sum(n for _, n in ships[:N_REQUESTS])
        out.update({
            "requests": N_REQUESTS, "head_tokens": SF_HEAD,
            "tail_tokens": tails, "max_tokens": MAX_TOKENS,
            "handoff_equal_unified_warm": sum(
                a == b for a, b in zip(handoff, warm)),
            "handoff_equal_unified_cold": sum(
                a == b for a, b in zip(handoff, cold)),
            "first_differences_vs_cold": cold_diffs,
            "pages_bit_equal": pages_equal,
            "page_ships": dec_snap["fleet_kv"]["page_ships"],
            "ship_bytes": ship_bytes,
            "ship_ms_per_page": (sum(ms for ms, _ in ships[:N_REQUESTS])
                                 / max(shipped, 1)),
            "ship_calls_ms": [ms for ms, _ in ships[:N_REQUESTS]],
            "decode_prefill_tokens": dec_snap["prefill_tokens"]
            - before["decode"]["prefill_tokens"],
            "tail_only_tokens": tail_tokens,
            "prefill_role": {k: pre_snap[k] for k in (
                "decode_step_programs", "dispatches", "prefill_tokens",
                "fleet_kv")},
            "ttft_ms_p50": {"handoff": pct(handoff_ttft, 0.5),
                            "unified_cold": pct(cold_ttft, 0.5)},
            "ttft_ms": {"handoff": handoff_ttft, "unified_cold": cold_ttft},
            "launches": {"flash_fwd": k1_prefill_role,
                         "paged_decode": k4_decode_role},
            "chaos_fallback": {
                "equal_cold": fallback == lone_cold,
                "ship_failures": end["decode"]["fleet_kv"]["ship_failures"]
                - fails},
            "pools_balanced": {r: page_balance(loops[r]) for r in loops},
            "pages_in_use": {r: end[r]["pages_in_use"] for r in end}})
        shared["disagg_handoff"] = handoff
        ok = (handoff == warm and near_ties(cold_diffs, TOL[FULL.dtype],
                                            FULL.dtype)
              and pages_equal
              and out["decode_prefill_tokens"] == tail_tokens
              and pre_snap["decode_step_programs"] == 0
              and pre_snap["dispatches"] == 0
              and k1_prefill_role > 0 and k4_decode_role > 0
              and fallback == lone_cold
              and out["chaos_fallback"]["ship_failures"] == 1
              and all(out["pools_balanced"].values())
              and all(v == 0 for v in out["pages_in_use"].values()))
    finally:
        for h in handles.values():
            h.close()
    out["ok"] = ok
    return out


# ------------------------------------------ the fleet and its router
#: the fleet phase: replicas, the router's monitor (probes on a card
#: whose host threads the decode loops keep busy get a generous timeout),
#: the step a rolling /reload pins, the failover's chaos ordinal
FLEET_REPLICAS, FLEET_RELOAD_STEP, FLEET_RESET_AT = 2, 7, 3
FLEET_MONITOR = {"heartbeat_interval": 0.5, "heartbeat_timeout": 30.0,
                 "probe_timeout": 10.0}
FLEET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_fleet"


def stream_events(url, body, timeout=600):
    """One streamed /generate: [(seconds since the request, event)]."""
    from urllib import request

    req = request.Request(url + "/generate",
                          data=json.dumps({**body, "stream": True}).encode(),
                          headers={"Content-Type": "application/json"})
    t0, events = time.perf_counter(), []
    with request.urlopen(req, timeout=timeout) as r:
        while True:
            line = r.readline()
            if not line:
                break
            if line.strip():
                events.append((time.perf_counter() - t0, json.loads(line)))
    return events


def router_round(url, prompts, streamed, **body):
    """Phase 5's requests at once through a router, the streamed ones
    streamed: (each row's tokens, record with tokens/s and TTFT p50)."""
    t0 = time.perf_counter()
    res = concurrently([
        lambda i=i: http_generate(url, prompts[i], MAX_TOKENS,
                                  i in streamed, **body)
        for i in range(len(prompts))])
    wall = time.perf_counter() - t0
    ttft = [r[1] for r in res if r[1] is not None]
    return [r[0] for r in res], {
        "wall_s": wall, "tokens_per_s": sum(len(r[0]) for r in res) / wall,
        "ttft_ms_streamed": ttft, "ttft_ms_p50": pct(ttft, 0.5)}


def fleet_series(url, label) -> dict:
    """This fleet's dl4j_fleet_* samples on the router's /metrics."""
    text = http_get(url + "/metrics")[1].decode()
    return {ln.split("{")[0]: float(ln.split()[-1])
            for ln in text.splitlines()
            if ln.startswith("dl4j_fleet_") and f'fleet="{label}"' in ln
            and "_bucket{" not in ln}


def group_gone(proc) -> bool:
    """The spawned replica and every process of its group have exited."""
    if proc.poll() is None:
        return False
    try:
        os.killpg(proc.pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    return False


def phase_fleet(device, seed, params, timer, shared):
    """The fleet and its router (serving/fleet.py, serving/router.py)
    over replica servers on the card, at full width (the 110M bf16 LM, 8
    slots, page_size 16, 512 pages a replica).

    (a) Two serve_network servers on threads of this process, attached
        by URL behind serve_fleet: phase 5's 16 requests through the
        router (half streamed) against an in-process DecodeLoop; a
        mid-stream failover (a chaos reset of the serving replica's
        stream, as the JAX package's in-process drills do: the router
        re-prefills prompt + delivered on the survivor, through K1 or
        the float32 context path where the victim decoded those tokens
        through K4, so in bf16 the resumed tokens are held identical or
        near-ties, not bit-identical); a rolling /reload of the served
        network from a step-N checkpoint. K1 and K4 counted (the
        wrappers and both loops' graph replays) as the "fleet" path.
    (b) Two `cli serve --device cuda` processes spawned by ReplicaSpawner
        sharing the card: the same requests through the router; each
        child's /stats shows its decode-graph launches (read there, not
        counted on the fleet path); Fleet.close(stop_replicas=True)
        leaves no process group behind.
    (c) A prefill-role and a decode-role server attached; the router
        drives /prefill and then kv_donor itself for the disagg phase's
        prompts: tail-only prefill on the decode replica, no graph on
        the prefill replica, tokens as the disagg phase's handoff. K1
        and K4 counted on the "fleet" path."""
    from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
    from deeplearning4j_tpu_torch.serving import (Fleet, ReplicaSet,
                                                  ReplicaSpawner,
                                                  serve_fleet, serve_network)
    from deeplearning4j_tpu_torch.testing import chaos

    out, ok = {"card": nvidia_smi()}, True
    prompts = serve_requests(seed)
    streamed = set(range(0, N_REQUESTS, 2))
    ref_toks, ref_rec = in_process_reference(params, prompts, device)
    launches = {"flash_fwd": 0, "paged_decode": 0}

    def count(loops, graphs_before):
        torch.cuda.synchronize()
        for name, mod in (("flash_fwd", flash), ("paged_decode", paged)):
            launches[name] += mod.launches + sum(
                lp.graph_launches()[name] - g[name]
                for lp, g in zip(loops, graphs_before))

    # ------------------------------------- (a) attached, in process
    nets = [MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
            for _ in range(FLEET_REPLICAS)]
    gens = [InferenceEngine.for_transformer(params, FULL, device=device)
            for _ in range(FLEET_REPLICAS)]
    handles = [serve_network(net, generate_engine=gen, slots=SLOTS,
                             page_size=PAGE_SIZE, kv_pages=SF_PAGES,
                             max_delay_ms=2.0, warmup_shape=(784,))
               for net, gen in zip(nets, gens)]
    loops = [g.decode_loop for g in gens]
    fleet = Fleet(**FLEET_MONITOR)
    router = None
    a = {}
    try:
        for h in handles:
            fleet.attach(h.url)
        fleet.wait_ready(FLEET_REPLICAS, timeout=120)
        router = serve_fleet(fleet)
        graphs_before = [lp.graph_launches() for lp in loops]
        paged.launches = flash.launches = 0
        # the first round captures both loops' step graphs (one at a
        # time); the second, outside the prefix cache, is the timed one
        first, a["router_first"] = router_round(router.url, prompts,
                                                streamed)
        toks, a["router"] = router_round(router.url, prompts, streamed,
                                         prefix_cache=False)
        a.update({"in_process": {k: ref_rec[k] for k in (
                      "tokens_per_s", "ttft_ms_p50", "wall_s")},
                  "equal_in_process": sum(x == y for x, y in
                                          zip(toks, ref_toks)),
                  "first_round_equal_in_process": sum(
                      x == y for x, y in zip(first, ref_toks)),
                  "served": [h.stats()["generate"]["decode"]["requests"]
                             for h in handles]})
        ok = ok and all(n > 0 for n in a["served"])

        # failover: the serving replica's stream resets mid-stream
        victim = max(range(N_REQUESTS), key=lambda i: len(prompts[i]))
        body = {"prompt": [prompts[victim]], "max_tokens": MAX_TOKENS}
        clean = stream_events(router.url, body)
        chaos.configure([chaos.Rule("generate.midstream", "reset",
                                    at=[FLEET_RESET_AT])])
        try:
            hit = stream_events(router.url, body)
        finally:
            chaos.deactivate()
        resumed = [(t, e) for t, e in hit if "token" in e]
        clean_toks = [e["token"] for _, e in clean if "token" in e]
        times = [t for t, _ in resumed]
        gaps = [(y - x) * 1e3 for x, y in zip(times, times[1:])]
        series = fleet_series(router.url, fleet.label)
        done = hit[-1][1]
        a["failover"] = {
            "prompt_tokens": len(prompts[victim]),
            "token_index_gapless": [e["token_index"] for _, e in resumed]
            == list(range(MAX_TOKENS)),
            "resumes": done.get("resumes"),
            "equal_uninterrupted": [e["token"] for _, e in resumed]
            == clean_toks,
            "ms_failover_to_resumed_token": max(gaps),
            "ms_between_tokens_p50": pct(gaps, 0.5),
            "stream_resumes_total": series.get(
                "dl4j_fleet_stream_resumes_total", 0.0),
            "stream_tokens_replayed_total": series.get(
                "dl4j_fleet_stream_tokens_replayed_total", 0.0)}
        ok = (ok and a["failover"]["token_index_gapless"]
              and done.get("done") is True and done.get("resumes", 0) >= 1
              and a["failover"]["stream_resumes_total"] >= 1)

        # rolling /reload of the served network from a step-N checkpoint
        fleet.wait_ready(FLEET_REPLICAS, timeout=60)
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
        ck = FLEET_DIR / "mlp"
        with ShardedModelSaver(str(ck)) as saver:
            saver.save(nets[0], step=FLEET_RELOAD_STEP, wait=True)
        probe = {"prompt": [prompts[0][:64]], "max_tokens": 16,
                 "prefix_cache": False}
        before = http_post(router.url + "/generate", probe)["tokens"]
        t0 = time.perf_counter()
        reload = http_post(router.url + "/reload",
                           {"path": str(ck), "step": FLEET_RELOAD_STEP})
        reload_s = time.perf_counter() - t0
        after = http_post(router.url + "/generate", probe)["tokens"]
        steps = [json.loads(http_get(h.url + "/readyz")[1])["checkpoint"]
                 for h in handles]
        x = np.round(np.random.default_rng(seed + 60).uniform(
            size=(32, 784)), 3).astype(np.float32)
        with torch.no_grad():
            want = nets[0].output(torch.from_numpy(x).to(device)).float()
        got = torch.tensor(http_post(router.url + "/predict",
                                     {"inputs": x.tolist()})["outputs"])
        a["reload"] = {
            "reloaded": reload.get("reloaded"), "seconds": reload_s,
            "replicas": len(reload.get("replicas", [])),
            "readyz_checkpoints": steps,
            "tokens_unchanged": before == after,
            "predict_max_abs_err": max_err(got, want.cpu()),
            "pools_balanced": [page_balance(lp) for lp in loops]}
        ok = (ok and reload.get("reloaded") is True
              and all(c and c["step"] == FLEET_RELOAD_STEP for c in steps)
              and before == after
              and a["reload"]["predict_max_abs_err"] <= TOL[torch.bfloat16]
              and all(a["reload"]["pools_balanced"]))
        # counted before the reference runs: its forward passes go
        # through the counting K1 wrapper too
        count(loops, graphs_before)
        a["launches"] = dict(launches)
        diffs = first_differences(params, FULL, prompts, ref_toks, toks)
        diffs += first_differences(params, FULL, prompts, ref_toks, first)
        fo_diffs = first_differences(
            params, FULL, [prompts[victim]], [clean_toks],
            [[e["token"] for _, e in resumed]])
        a["first_differences"] = diffs
        a["failover"]["first_differences"] = fo_diffs
        ok = (ok and near_ties(diffs, TOL[FULL.dtype], FULL.dtype)
              and near_ties(fo_diffs, TOL[FULL.dtype], FULL.dtype))
        a["fleet_stats"] = {k: v for k, v in
                            json.loads(http_get(router.url + "/stats")[1])[
                                "fleet"].items()
                            if k in ("states", "requests", "evictions",
                                     "readmissions", "stream_resumes",
                                     "stream_tokens_replayed", "reloads")}
    finally:
        if router is not None:
            router.close()
        else:
            fleet.close()
        for h in handles:
            h.close()
    out["attached"] = a
    del handles, loops, gens

    # ------------------------------------------- (b) spawned replicas
    FLEET_DIR.mkdir(parents=True, exist_ok=True)
    conf = FLEET_DIR / "conf.json"
    conf.write_text(mlp_conf("bfloat16").to_json())
    spec = json.dumps({"vocab_size": FULL.vocab_size,
                       "d_model": FULL.d_model, "n_heads": FULL.n_heads,
                       "n_layers": FULL.n_layers, "d_ff": FULL.d_ff,
                       "max_len": FULL.max_len, "dtype": "bfloat16",
                       "seed": seed})
    repo = str(Path(__file__).resolve().parent)
    spawner = ReplicaSpawner(
        str(conf), env=dict(os.environ, PYTHONPATH=repo),
        serve_args=["--transformer", spec, "--device", "cuda",
                    "--slots", str(SLOTS), "--page-size", str(PAGE_SIZE),
                    "--kv-pages", str(SF_PAGES), "--max-delay-ms", "2"])
    fleet = Fleet(spawner=spawner, **FLEET_MONITOR)
    router, b = None, {}
    spawned_procs = []
    try:
        t0 = time.time()
        reps = fleet.spawn(FLEET_REPLICAS)
        spawned_procs = [r.proc for r in reps]
        fleet.wait_ready(FLEET_REPLICAS, timeout=300)
        b["boot_to_ready_s"] = [r.admitted_at - t0 for r in reps]
        router = serve_fleet(fleet)
        first, b["router_first"] = router_round(router.url, prompts,
                                                streamed)
        toks, b["router"] = router_round(router.url, prompts, streamed,
                                         prefix_cache=False)
        diffs = first_differences(params, FULL, prompts, ref_toks, toks)
        diffs += first_differences(params, FULL, prompts, ref_toks, first)
        b["equal_in_process"] = sum(x == y for x, y in zip(toks, ref_toks))
        b["first_round_equal_in_process"] = sum(
            x == y for x, y in zip(first, ref_toks))
        b["first_differences"] = diffs
        child = [r.client.stats()["generate"]["decode"] for r in reps]
        b["children"] = [{
            "pid": r.proc.pid, "requests": c["requests"],
            "decode_graph_launches": c["decode_graphs"]["kernel_launches"],
            "decode_step_programs": c["decode_step_programs"],
            "pages_in_use": c["pages_in_use"]} for r, c in zip(reps, child)]
        ok = (ok and near_ties(diffs, TOL[FULL.dtype], FULL.dtype)
              and all(c["decode_graph_launches"]["paged_decode"] > 0
                      for c in b["children"]))
    finally:
        if router is not None:
            router.close(stop_replicas=True)
        else:
            fleet.close(stop_replicas=True)
    b["no_process_left"] = all(group_gone(p) for p in spawned_procs)
    ok = ok and b["no_process_left"] and len(spawned_procs) == FLEET_REPLICAS
    out["spawned"] = b
    shutil.rmtree(FLEET_DIR, ignore_errors=True)

    # ----------------------------- (c) the router's disaggregated handoff
    d_prompts, _, lone = disagg_prompts(seed)
    predict = ReplicaSet([InferenceEngine.for_network(
        MultiLayerNetwork(mlp_conf("bfloat16"), device=device))])
    roles = {}
    for role in ("prefill", "decode"):
        gen = InferenceEngine.for_transformer(params, FULL, device=device)
        roles[role] = (serve_network(
            replicas=predict, generate_engine=gen, slots=SLOTS,
            page_size=PAGE_SIZE, kv_pages=SF_PAGES, fleet_kv="on",
            kv_ship_timeout=60.0, role=role), gen.decode_loop)
    fleet = Fleet(**FLEET_MONITOR)
    router, c = None, {}
    try:
        for h, _ in roles.values():
            fleet.attach(h.url)
        fleet.wait_ready(2, timeout=120)
        router = serve_fleet(fleet, fleet_kv="on")
        dec = roles["decode"][1]
        pre = roles["prefill"][1]
        # capture the decode replica's step graph outside the handoffs
        http_generate(roles["decode"][0].url, lone[:24], 4, False,
                      prefix_cache=False)
        before = dec.snapshot()
        graphs_before = [lp.graph_launches() for lp in (pre, dec)]
        paged.launches = flash.launches = 0
        toks, ttft = [], []
        for p in d_prompts:
            t, first, _ = http_generate(router.url, p, MAX_TOKENS, True)
            toks.append(t)
            ttft.append(first)
        count((pre, dec), graphs_before)
        end, pre_snap = dec.snapshot(), pre.snapshot()
        disagg = json.loads(http_get(router.url + "/stats")[1])[
            "fleet"]["disagg"]
        ref = shared["disagg_handoff"]
        diffs = first_differences(params, FULL, d_prompts, ref, toks)
        tail = sum(len(p) % PAGE_SIZE for p in d_prompts)
        c.update({
            "roles": fleet.role_counts(), "router_disagg": disagg,
            "equal_disagg_phase": sum(x == y for x, y in zip(toks, ref)),
            "first_differences": diffs,
            "decode_prefill_tokens": end["prefill_tokens"]
            - before["prefill_tokens"],
            "tail_only_tokens": tail,
            "page_ships": end["fleet_kv"]["page_ships"]
            - before["fleet_kv"]["page_ships"],
            "prefill_role": {
                "decode_step_programs": pre_snap["decode_step_programs"],
                "dispatches": pre_snap["dispatches"],
                "graph_launches": pre.graph_launches()},
            "ttft_ms_p50": pct(ttft, 0.5), "ttft_ms": ttft,
            "pools_balanced": [page_balance(lp) for lp in (pre, dec)]})
        ok = (ok and near_ties(diffs, TOL[FULL.dtype], FULL.dtype)
              and disagg["handoffs"] == N_REQUESTS
              and disagg["handoff_failures"] == 0
              and c["decode_prefill_tokens"] == tail
              and pre_snap["decode_step_programs"] == 0
              and pre_snap["dispatches"] == 0
              and not any(pre.graph_launches().values())
              and all(c["pools_balanced"]))
    finally:
        if router is not None:
            router.close()
        else:
            fleet.close()
        for h, _ in roles.values():
            h.close()
    out["handoff"] = c
    out["launches"] = launches
    ok = ok and launches["flash_fwd"] > 0 and launches["paged_decode"] > 0
    out["ok"] = ok
    return out


def flash_counts() -> dict:
    return {"flash_fwd": flash.launches, "flash_bwd_dq": flash.dq_launches,
            "flash_bwd_dkv": flash.dkv_launches}


def reset_flash_counts() -> None:
    flash.launches = flash.dq_launches = flash.dkv_launches = 0


def leaf_items(tree, prefix=""):
    """(path, tensor) for every leaf of a params-shaped tree."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in leaf_items(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in leaf_items(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def cyclic_tokens(seed, n_batches, b, t, period=5):
    """tokens[i] = (offset + i) % period, a random offset per row: a
    learnable sequence (the JAX package's tests/test_transformer.py
    builds its training data the same way)."""
    off = np.random.RandomState(seed).randint(0, period, (n_batches, b, 1))
    return torch.from_numpy(((off + np.arange(t)[None, None, :]) % period)
                            .astype(np.int32))


def phase_train_parity(device, seed):
    """Full width cut to 2 layers, float32: the loss, every gradient leaf
    and the params after 2 train steps on the card (kernels) against the
    same weights on the CPU (plain versions), at a ragged T."""
    cfg = FULL._replace(n_layers=2, dtype=torch.float32)
    params = init_transformer_params(seed, cfg, device=device)
    cpu_params = params_to_device(params, "cpu")
    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 301))
                            .astype(np.int32))
    torch.cuda.synchronize()
    reset_flash_counts()
    loss, grads = lm_loss_and_grads(params, toks[0].to(device), cfg)
    torch.cuda.synchronize()
    launches = flash_counts()
    cpu_loss, cpu_grads = lm_loss_and_grads(cpu_params, toks[0], cfg)
    grad_rel = {}
    for (name, g), (_, cg) in zip(leaf_items(grads), leaf_items(cpu_grads)):
        grad_rel[name] = max_err(g.cpu(), cg) / max(
            float(cg.abs().max()), 1e-30)
    embed_rel = grad_rel.pop("/embed")
    zero_leaves = [n for n, g in leaf_items(grads)
                   if float(g.abs().max()) == 0.0]
    step, cpu_step = make_train_step(cfg), make_train_step(cfg)
    vel, cpu_vel = init_velocity(params), init_velocity(cpu_params)
    for tok in toks[1:]:
        params, vel, _ = step(params, vel, tok.to(device))
        cpu_params, cpu_vel, _ = cpu_step(cpu_params, cpu_vel, tok)
    param_diff = max(max_err(a.cpu(), b) for (_, a), (_, b) in
                     zip(leaf_items(params), leaf_items(cpu_params)))
    loss_diff = abs(float(loss) - float(cpu_loss))
    worst_leaf = max(grad_rel, key=grad_rel.get)
    tol = TRAIN_PARITY_TOL
    ok = (loss_diff <= tol["loss"] and grad_rel[worst_leaf] <= tol["grad"]
          and embed_rel <= tol["embed_grad"]
          and param_diff <= tol["params"] and not zero_leaves
          and launches == {k: cfg.n_layers for k in launches})
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "tokens": list(toks.shape[1:]), "loss": float(loss),
            "loss_abs_diff": loss_diff,
            "grad_max_rel_diff": grad_rel[worst_leaf],
            "grad_worst_leaf": worst_leaf,
            "embed_grad_rel_diff": embed_rel,
            "params_after_2_steps_max_abs_diff": param_diff,
            "leaves_with_zero_grad": zero_leaves,
            "launches_one_loss_and_grad": launches,
            "tolerances": tol, "ok": ok}


def phase_train(device, seed):
    """The training path at full width: TRAIN_STEPS make_train_step
    steps, then fit_scan over the batches."""
    params = init_transformer_params(seed, FULL, device=device)
    batches = cyclic_tokens(seed, TRAIN_BATCHES, TRAIN_B,
                            TRAIN_T + 1).to(device)
    step = make_train_step(FULL, lr=TRAIN_LR)
    velocity = init_velocity(params)
    torch.cuda.synchronize()
    reset_flash_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, velocity, loss = step(params, velocity,
                                      batches[i % TRAIN_BATCHES])
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_launches = flash_counts()
    losses = torch.stack(losses).tolist()
    step_ms = [a.elapsed_time(b) for a, b in events]
    t0 = time.perf_counter()
    params, last = fit_scan(params, batches, FULL, lr=TRAIN_LR)
    last = float(last)
    fit_s = time.perf_counter() - t0
    launches = flash_counts()
    per_step = FULL.n_layers
    ok = (all(np.isfinite(losses)) and np.isfinite(last)
          and max(losses[-1], last) < 0.5 * losses[0]
          and step_launches == {k: per_step * TRAIN_STEPS
                                for k in step_launches}
          and launches == {k: per_step * (TRAIN_STEPS + TRAIN_BATCHES)
                           for k in launches})
    tokens_per_step = TRAIN_B * TRAIN_T
    steady = sorted(step_ms[1:])
    return {"params": count_params(params), "layers": FULL.n_layers,
            "d_model": FULL.d_model, "heads": FULL.n_heads,
            "vocab": FULL.vocab_size, "dtype": "bfloat16",
            "batch": TRAIN_B, "tokens_per_row": TRAIN_T + 1,
            "lr": TRAIN_LR, "steps": TRAIN_STEPS, "losses": losses,
            "fit_scan_batches": TRAIN_BATCHES, "fit_scan_last_loss": last,
            "fit_scan_s": fit_s, "step_ms": step_ms,
            "step_ms_p50": steady[len(steady) // 2],
            "tokens_per_s": tokens_per_step * TRAIN_STEPS / wall,
            "tokens_per_s_p50_step": tokens_per_step / (
                steady[len(steady) // 2] / 1e3),
            "launches_steps": step_launches, "launches": launches,
            "ok": ok}, params, batches


def train_timing(device, timer, params, batches, seed, worst, launches):
    """K1 (with its lse), K2 and K3 at the training path's attention shape
    beside their plain version, the library call and their bound; one
    whole training step, timed and profiled."""
    gen = torch.Generator().manual_seed(seed + 3)
    dt = FULL.dtype
    hd = FULL.d_model // FULL.n_heads
    bh, t = TRAIN_B * FULL.n_heads, TRAIN_T
    q, k, v, do = (torch.randn(TRAIN_B, FULL.n_heads, t, hd, generator=gen)
                   .to(device, dt) for _ in range(4))
    q3, k3, v3, do3 = (x.reshape(bh, t, hd) for x in (q, k, v, do))
    out, lse = flash.flash_attention_with_lse(q3, k3, v3, True)
    dd = flash._delta(out, do3).contiguous()
    args = (q3, k3, v3, out, lse, do3, True)
    errs = rel_errs(flash._flash_backward(*args),
                    flash.flash_attention_bwd_ref(*args))
    if max(r for _, r in errs) > BWD_TOL[dt]:
        raise AssertionError(f"flash backward disagrees at the training "
                             f"shape: {errs}")
    plain_ms = timer.ms(lambda: flash.flash_attention_bwd_ref(*args),
                        iters=5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_ms, lib_runs = library_ms(timer, lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True))
    shape = {"bh": bh, "t": t, "hd": hd, "dtype": "bfloat16",
             "causal": True}
    rows = []
    for name, fn, idx in (
            ("dq", lambda: flash._launch_dq(q3, k3, v3, do3, lse, dd, True),
             (0,)),
            ("dkv", lambda: flash._launch_dkv(q3, k3, v3, do3, lse, dd, True),
             (1, 2))):
        key = f"flash_bwd_{name}"
        nbytes, ops = flash_bwd_work(name, bh, t, t, hd, True, dt)
        bound, by = bound_ms(nbytes, ops, dt)
        rows.append({
            "name": key, "route": "cuda", "design": DESIGN[key],
            "source": "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
            "replaces": {"dq": "deeplearning4j_tpu/attention/"
                               "flash_pallas.py:312",
                         "dkv": "deeplearning4j_tpu/attention/"
                                "flash_pallas.py:375"}[name],
            "launches": launches[key],
            "max_abs_err": max(worst[key], *(errs[i][0] for i in idx)),
            "max_rel_err": max(worst[key + "_rel"],
                               *(errs[i][1] for i in idx)),
            "ms": timer.ms(fn), "plain_ms": plain_ms,
            "plain_covers": "dQ, dK and dV together",
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library_ms_batches": lib_runs,
            "library_covers": "SDPA backward: dQ, dK and dV together",
            "shape": shape})
    nbytes, ops = flash_work(bh, t, t, hd, True, dt)
    k1_bound, k1_by = bound_ms(nbytes, ops, dt)
    k1_lib, k1_lib_runs = library_ms(
        timer, lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True))
    k1_train = {"ms": timer.ms(lambda: flash.flash_attention_with_lse(
                    q3, k3, v3, True)),
                "bound_ms": k1_bound, "bound_by": k1_by,
                "library_ms": k1_lib, "library_ms_batches": k1_lib_runs,
                "shape": shape, "with_lse": True}
    step = make_train_step(FULL, lr=TRAIN_LR)
    velocity = init_velocity(params)

    def one_step():
        return step(params, velocity, batches[0])

    groups = {"flash_fwd": "flash_fwd_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel",
              "flash_bwd_dkv": "flash_bwd_dkv_kernel",
              "cublas_gemm": "nvjet", "elementwise": "elementwise_kernel",
              "reduce": "reduce_kernel"}
    return rows, {
        "train_shape_flash_fwd": k1_train,
        "train_step_ms": timer.ms(one_step, iters=3),
        "train_step_profile": device_profile(one_step, iters=2,
                                             groups=groups)}


def main_path_timing(device, timer, params, plens, serve, seed, worst,
                     launches):
    """Each kernel at the shapes the serve phase gave it, beside its plain
    version, the library call and its bound; plus one whole prefill and
    one whole decode step of the 8-layer model."""
    gen = torch.Generator().manual_seed(seed + 1)
    dt = FULL.dtype
    hd = FULL.d_model // FULL.n_heads
    # K1: the prefill group with the most attention work
    bb, tb = max(serve["prefill_groups"], key=lambda g: g[0] * g[1] ** 2)
    bh = bb * FULL.n_heads
    q, k, v = (torch.randn(bb, FULL.n_heads, tb, hd, generator=gen)
               .to(device, dt) for _ in range(3))
    q3, k3, v3 = (x.reshape(bh, tb, hd) for x in (q, k, v))
    f_err = max_err(flash.flash_attention(q3, k3, v3, True),
                    flash.flash_attention_ref(q3, k3, v3, True))
    nbytes, ops = flash_work(bh, tb, tb, hd, True, dt)
    f_bound, f_by = bound_ms(nbytes, ops, dt)
    f_lib, f_lib_runs = library_ms(
        timer, lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True))
    k1 = {"name": "flash_fwd", "route": "cuda",
          "design": DESIGN["flash_fwd"],
          "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
          "replaces": "deeplearning4j_tpu/attention/flash_pallas.py:92",
          "launches": launches["flash_fwd"],
          "max_abs_err": max(worst["flash_fwd"], f_err),
          "ms": timer.ms(lambda: flash.flash_attention(q3, k3, v3, True)),
          "plain_ms": timer.ms(lambda: flash.flash_attention_ref(
              q3, k3, v3, True), iters=5),
          "bound_ms": f_bound, "bound_by": f_by,
          "library_ms": f_lib, "library_ms_batches": f_lib_runs,
          "shape": {"bh": bh, "t": tb, "hd": hd, "dtype": "bfloat16",
                    "causal": True}}
    # K4: the decode step with 8 slots mid-generation (cursor = prompt +
    # 32 tokens), on a pool the size of the serve phase's
    lengths = [p + 32 for p in plens[:SLOTS]]
    width = paged_kv.pages_per_slot(FULL, PAGE_SIZE)
    args = paged_inputs(gen, device, dt, FULL.n_heads, hd, lengths + [0],
                        n_pages=serve["n_pages"], width=width)
    args = (args[0][:SLOTS].contiguous(), args[1], args[2],
            args[3][:SLOTS].contiguous(), args[4][:SLOTS].contiguous())
    p_err = max_err(paged.paged_attention(*args),
                    paged.paged_attention_ref(*args))
    nbytes, ops = paged_work(lengths, FULL.n_heads, hd, PAGE_SIZE, width, dt)
    p_bound, p_by = bound_ms(nbytes, ops, dt)
    k4 = {"name": "paged_decode", "route": "cuda",
          "design": DESIGN["paged_decode"],
          "source": "deeplearning4j_tpu_torch/csrc/paged_decode.cu",
          "replaces": "deeplearning4j_tpu/attention/paged_pallas.py:51",
          "launches": launches["paged_decode"],
          "kernel_functions": list(PAGED_KERNELS),
          "max_abs_err": max(worst["paged_decode"], p_err),
          "ms": timer.ms(lambda: paged.paged_attention(*args)),
          "plain_ms": timer.ms(lambda: paged.paged_attention_ref(*args),
                               iters=5),
          "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
          "shape": {"slots": SLOTS, "heads": FULL.n_heads, "hd": hd,
                    "page_size": PAGE_SIZE, "table_width": width,
                    "lengths": lengths, "dtype": "bfloat16"}}
    if max(f_err, p_err) > TOL[dt]:
        raise AssertionError(f"kernel disagrees at main-path shapes: "
                             f"flash {f_err}, paged {p_err}")
    # whole-model steps at the same shapes
    n_pages = serve["n_pages"]
    pool = paged_kv.init_paged_pool(FULL, n_pages, PAGE_SIZE, device=device)
    toks = torch.randint(0, FULL.vocab_size, (bb, tb), generator=gen,
                         dtype=torch.int32).to(device)
    tl = torch.full((bb,), tb, dtype=torch.int32, device=device)
    pids = torch.arange(bb * tb // PAGE_SIZE, dtype=torch.int32,
                        device=device).reshape(bb, -1) % n_pages
    prefill_ms = timer.ms(lambda: paged_kv.paged_prefill(
        params, toks, tl, pool, pids, FULL), iters=3)
    dtok = torch.randint(0, FULL.vocab_size, (SLOTS,), generator=gen,
                         dtype=torch.int32).to(device)
    active = torch.ones(SLOTS, dtype=torch.bool, device=device)
    def step():
        return paged_kv.paged_decode_step(params, dtok, pool, args[3],
                                          args[4], active, FULL,
                                          kernel="kernel")

    step_ms = timer.ms(step, iters=5)
    return [k1, k4], {
        "prefill_group": [bb, tb], "prefill_ms": prefill_ms,
        "decode_step_ms": step_ms,
        "decode_step_profile": device_profile(step, iters=5, groups={
            "paged_decode": "paged_decode", "cublas_gemm": "nvjet",
            "elementwise": "elementwise_kernel"}),
        "prefill_profile": device_profile(lambda: paged_kv.paged_prefill(
            params, toks, tl, pool, pids, FULL), iters=2, groups={
                "flash_fwd": "flash_fwd_kernel", "cublas_gemm": "nvjet",
                "elementwise": "elementwise_kernel"})}


# ------------------------------------------------------- layer network
def mlp_conf(compute_dtype):
    """BASELINE config 1 (bench.py:79-96): 784-2048-1024-10, AdaGrad."""
    return (NeuralNetConfiguration.builder()
            .lr(0.05).n_in(784).activation_function("relu")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).batch_size(ML_TRAIN["mlp"][0])
            .compute_dtype(compute_dtype)
            .list(3).hidden_layer_sizes([2048, 1024])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=10)
            .pretrain(False).build())


def lenet_builder():
    """LeNet-5 as __graft_entry__.entry() builds it: two 5x5 conv + 2x2
    pool layers (6, 16 maps), dense 256 -> 120, softmax output."""
    return (NeuralNetConfiguration.builder()
            .activation_function("relu").num_iterations(1))


def lenet_layers(builder):
    return (builder.list(4)
            .override(0, layer="conv", filter_size=[5, 5], stride=[2, 2],
                      num_in_feature_maps=1, num_feature_maps=6)
            .override(1, layer="conv", filter_size=[5, 5], stride=[2, 2],
                      num_in_feature_maps=6, num_feature_maps=16)
            .override(2, layer="dense", n_in=4 * 4 * 16, n_out=120)
            .override(3, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=120, n_out=10)
            .input_preprocessor(0, ConvolutionInputPreProcessor(28, 28, 1))
            .input_preprocessor(2, ConvolutionPostProcessor())
            .pretrain(False).build())


def lenet_conf(compute_dtype):
    """BASELINE config 2 (bench.py:174-221): LeNet, SGD lr 0.05."""
    return lenet_layers(lenet_builder().lr(0.05).use_adagrad(False)
                        .batch_size(ML_TRAIN["lenet"][0])
                        .compute_dtype(compute_dtype))


def attention_conf(compute_dtype):
    """Row-sequence MNIST: each image's 28 rows a sequence of 28-wide
    tokens, self-attention 28 -> 128 (one head of 128), flattened into a
    softmax output 784 -> 10; SGD lr 0.05."""
    return (NeuralNetConfiguration.builder()
            .lr(0.05).use_adagrad(False).num_iterations(1)
            .batch_size(ML_TRAIN["attention"][0])
            .compute_dtype(compute_dtype)
            .list(2)
            .override(0, layer="self_attention", n_in=28, n_out=128,
                      n_heads=1)
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=784, n_out=10)
            .input_preprocessor(0, ReshapePreProcessor([28, 28]))
            .input_preprocessor(1, ConvolutionPostProcessor())
            .pretrain(False).build())


def phase_multilayer_parity(device, seed):
    """Each stack at full width, float32: a CPU net and a card net on the
    same packed weights; the outputs, then the params after 2 fit steps
    on the same batches (the second ragged, so masked)."""
    confs = {"lenet": lenet_layers(lenet_builder()),
             "mlp": mlp_conf("float32"), "attention": attention_conf(
                 "float32")}
    b = ML_PARITY_BATCH
    x, y = synthetic_mnist(2 * b + ML_PARITY_TAIL, seed=seed)
    out = {}
    for name, conf in confs.items():
        cpu = MultiLayerNetwork(conf, device="cpu")
        card = MultiLayerNetwork.from_config_json(
            cpu.to_json(), params=cpu.params(), device=device)
        reset_flash_counts()
        fwd = max_err(card.output(x[:b]).cpu(), cpu.output(x[:b]))
        # 2 fit steps over an iterator, through the DeviceFeed (pinned
        # copies on the card): a full batch, then a ragged one padded to
        # the bucket and masked
        rows = slice(b, 2 * b + ML_PARITY_TAIL)
        data = DataSet(x[rows], y[rows])
        card.fit(ListDataSetIterator(data, b))
        cpu.fit(ListDataSetIterator(data, b))
        torch.cuda.synchronize()
        launches = flash_counts()
        params = max_err(card.params().cpu(), cpu.params())
        want = ({"flash_fwd": 3, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
                if name == "attention" else
                {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
        out[name] = {"params": card.num_params(),
                     "output_max_abs_diff": fwd,
                     "params_after_2_steps_max_abs_diff": params,
                     "launches": launches,
                     "ok": (fwd <= ML_PARITY_TOL["forward"]
                            and params <= ML_PARITY_TOL["params"]
                            and launches == want)}
    return {"dtype": "float32", "batch": b, "models": out,
            "tolerances": ML_PARITY_TOL,
            "ok": all(m["ok"] for m in out.values())}


ML_GROUPS = {"flash_fwd": "flash_fwd_kernel",
             "flash_bwd_dq": "flash_bwd_dq_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_kernel",
             "cublas_gemm": ("nvjet", "gemm", "Kernel2"),
             "unfold_cat": ("unfold", "CatArrayBatched"),
             "casts_copies": "copy_kern",
             "foreach_updater": "multi_tensor_apply",
             "elementwise": "elementwise_kernel", "reduce": "reduce_kernel"}


def train_multilayer(device, seed, name, conf):
    """One stack's training path; see the module docstring (phase 9)."""
    batch, n_batches, max_epochs = ML_TRAIN[name]
    net = MultiLayerNetwork(conf, device=device)
    x_np, y_np = synthetic_mnist(batch * n_batches + ML_EVAL_ROWS, seed=seed)
    n = batch * n_batches
    x = torch.from_numpy(x_np[:n]).to(device)
    y = torch.from_numpy(y_np[:n]).to(device)
    xb, yb = x.view(n_batches, batch, -1), y.view(n_batches, batch, -1)
    torch.cuda.synchronize()
    reset_flash_counts()
    losses, events = [], []
    for _ in range(2):
        for i in range(n_batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(net.fit_scan(xb[i], yb[i], batch, sync=False))
            end.record()
            events.append((start, end))
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    step_ms = [a.elapsed_time(b) for a, b in events]
    # one whole fit_scan epoch in which no host sync may happen
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        last = net.fit_scan(x, y, batch, epochs=1, sync=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    torch.cuda.synchronize()
    epoch_ms = start.elapsed_time(end)
    epoch_losses = [float(last)]
    epochs = 3
    while epoch_losses[-1] >= 0.5 * losses[0] and epochs < max_epochs:
        epoch_losses.append(net.fit_scan(x, y, batch))
        epochs += 1
    ev = Evaluation()
    ev.eval(y_np[n:], net.output(x_np[n:]))
    torch.cuda.synchronize()
    launches = flash_counts()
    steps = epochs * n_batches
    want = ({"flash_fwd": steps + 1, "flash_bwd_dq": steps,
             "flash_bwd_dkv": steps} if name == "attention" else
            {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    every = losses + epoch_losses
    steady = sorted(step_ms[1:])
    p50 = steady[len(steady) // 2]
    ok = (all(np.isfinite(every)) and every[-1] < 0.5 * losses[0]
          and launches == want)
    profile = device_profile(
        lambda: net.fit_scan(xb[0], yb[0], batch, sync=False), iters=3,
        groups=ML_GROUPS)
    return {"params": net.num_params(), "batch": batch,
            "batches": n_batches, "compute_dtype": conf.confs[0].compute_dtype,
            "lr": conf.confs[0].lr, "adagrad": conf.confs[0].use_adagrad,
            "step_losses": losses, "epoch_last_losses": epoch_losses,
            "epochs": epochs, "steps": steps,
            "step_ms": step_ms, "step_ms_p50": p50,
            "samples_per_s_p50_step": batch / (p50 / 1e3),
            "fit_scan_epoch_ms": epoch_ms,
            "fit_scan_epoch_ms_per_step": epoch_ms / n_batches,
            "samples_per_s_fit_scan_epoch": n / (epoch_ms / 1e3),
            "no_host_sync_in_epoch": True,
            "eval_rows": ML_EVAL_ROWS, "accuracy": ev.accuracy(),
            "launches": launches, "launches_expected": want,
            "step_profile": profile, "ok": ok}


def phase_multilayer_train(device, seed):
    models = {"mlp": mlp_conf("bfloat16"), "lenet": lenet_conf("bfloat16"),
              "attention": attention_conf("bfloat16")}
    out = {name: train_multilayer(device, seed, name, conf)
           for name, conf in models.items()}
    launches = {k: sum(m["launches"][k] for m in out.values())
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"bf16_product": bf16_product_route(device), "models": out,
            "launches": launches,
            "ok": all(m["ok"] for m in out.values())}


def multilayer_kernel_timing(device, timer, seed):
    """K1, K2 and K3 at the attention stack's shape (B*H 1024, T 28,
    hd 128, bf16, not causal) beside their plain version, bound and
    library call."""
    gen = torch.Generator().manual_seed(seed + 4)
    return kernel_timing_at(device, timer, gen, ML_TRAIN["attention"][0], 1,
                            28, 128, False, "the attention stack's shape")


def kernel_timing_at(device, timer, gen, b, h, t, hd, causal, what):
    """K1, K2 and K3 on (b, h, t, hd) bf16 inputs drawn from `gen`, at
    Tq = Tk = t: each against its plain version (raises past TOL /
    BWD_TOL), timed beside the plain version, its bound and the library
    call (SDPA forward; SDPA's backward for K2 and K3)."""
    dt = torch.bfloat16
    bh = b * h
    q, k, v, do = (torch.randn(b, h, t, hd, generator=gen).to(device, dt)
                   for _ in range(4))
    q3, k3, v3, do3 = (a.reshape(bh, t, hd) for a in (q, k, v, do))
    out, lse = flash.flash_attention_with_lse(q3, k3, v3, causal)
    dd = flash._delta(out, do3).contiguous()
    args = (q3, k3, v3, out, lse, do3, causal)
    f_err = max_err(out, flash.flash_attention_ref(q3, k3, v3, causal))
    b_errs = rel_errs(flash._flash_backward(*args),
                      flash.flash_attention_bwd_ref(*args))
    if f_err > TOL[dt] or max(r for _, r in b_errs) > BWD_TOL[dt]:
        raise AssertionError(f"flash kernels disagree at {what}: "
                             f"{f_err}, {b_errs}")
    shape = {"bh": bh, "t": t, "hd": hd, "dtype": "bfloat16",
             "causal": causal}
    f_bound, f_by = bound_ms(*flash_work(bh, t, t, hd, causal, dt), dt)
    f_lib, _ = library_ms(timer, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    b_lib, _ = library_ms(timer, lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True))
    b_plain = timer.ms(lambda: flash.flash_attention_bwd_ref(*args), iters=5)
    rows = {"flash_fwd": {
        "ms": timer.ms(lambda: flash.flash_attention(q3, k3, v3, causal)),
        "plain_ms": timer.ms(lambda: flash.flash_attention_ref(
            q3, k3, v3, causal), iters=5),
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib,
        "max_abs_err": f_err, "shape": shape}}
    for name, fn, idx in (
            ("dq", lambda: flash._launch_dq(q3, k3, v3, do3, lse, dd,
                                            causal), (0,)),
            ("dkv", lambda: flash._launch_dkv(q3, k3, v3, do3, lse, dd,
                                              causal), (1, 2))):
        bound, by = bound_ms(*flash_bwd_work(name, bh, t, t, hd, causal,
                                             dt), dt)
        rows[f"flash_bwd_{name}"] = {
            "ms": timer.ms(fn), "plain_ms": b_plain,
            "plain_covers": "dQ, dK and dV together", "bound_ms": bound,
            "bound_by": by, "library_ms": b_lib,
            "library_covers": "SDPA backward: dQ, dK and dV together",
            "max_abs_err": max(b_errs[i][0] for i in idx),
            "max_rel_err": max(b_errs[i][1] for i in idx), "shape": shape}
    return rows


# --------------------------------------------------------- batch solvers
SOLVER_ALGOS = ("iteration_gradient_descent", "gradient_descent",
                "conjugate_gradient", "lbfgs", "hessian_free")
SOLVER_ITERS = 5
SOLVER_PARITY_TOL = {"params": 1e-4, "bf16_hvp_rel": 3e-2,
                     "bf16_score_rel": 2e-2}
#: Hessian-free's starting damping in the parity runs: at the default 1
#: the test MLP's damped Hessian is indefinite, and CG's step then
#: multiplies float32 rounding differences by ~1e4 (tests/
#: test_torch_optimize.py's module docstring)
HF_PARITY_LAMBDA = 10.0


def solver_mlp_conf(algo, compute_dtype="float32"):
    """The solver parity MLP at test width: 20-32-16-5, tanh, softmax +
    mcxent, SGD + momentum (for IGD), SOLVER_ITERS iterations."""
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(20).activation_function("tanh")
            .optimization_algo(algo).num_iterations(SOLVER_ITERS)
            .use_adagrad(False).momentum(0.5)
            .compute_dtype(compute_dtype)
            .list(3).hidden_layer_sizes([32, 16])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=5)
            .pretrain(False).build())


def net_solver(net, algo_kw=None, listeners_=None):
    """A Solver over `net`'s whole loss as a function of the packed
    vector, and the packed start point."""
    x0, unravel = ravel_table(net.param_table)

    def loss(vec, bx, by):
        return net.loss_fn(unravel(vec), bx, by)

    return Solver(net.layers[-1].conf, loss, listeners=listeners_,
                  terminations=[], **(algo_kw or {})), x0, loss


def phase_solver_parity(device, seed):
    """Each optimizer SOLVER_ITERS iterations on the card against the
    port's CPU run from the same params and batch (float32); the two
    optimize() paths on the card (identical params); one optimize() of
    each under set_sync_debug_mode("error"); and Hessian-free's double
    backward through the bf16 product on the card vs the CPU."""
    rng = np.random.default_rng(seed + 6)
    xb = rng.uniform(size=(64, 20)).astype(np.float32)
    yb = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 64)]
    out = {}
    for algo in SOLVER_ALGOS:
        kw = ({"initial_lambda": HF_PARITY_LAMBDA}
              if algo == "hessian_free" else {})
        cpu = MultiLayerNetwork(solver_mlp_conf(algo), device="cpu")
        card = MultiLayerNetwork.from_config_json(
            cpu.to_json(), params=cpu.params(), device=device)
        data_cpu = (torch.from_numpy(xb), torch.from_numpy(yb))
        data = tuple(a.to(device) for a in data_cpu)
        solver, x0, _ = net_solver(card, kw)
        cpu_solver, cx0, _ = net_solver(cpu, kw)
        got, score = solver.optimize(x0, *data, sync=False)
        ref, ref_score = cpu_solver.optimize(cx0, *data_cpu)
        collect = CollectScoresListener()
        eager_solver, _, _ = net_solver(card, kw, [collect])
        eager, eager_score = eager_solver.optimize(x0, *data)
        sync_solver, _, _ = net_solver(card, kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced, _ = sync_solver.optimize(x0, *data, sync=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        diff = max_err(got.cpu(), ref)
        paths_equal = bool(torch.equal(got, eager)
                           and torch.equal(got, synced))
        out[algo] = {"params_max_abs_diff": diff,
                     "score_card": float(score), "score_cpu": ref_score,
                     "score_start": float(net_solver(cpu)[2](
                         cx0, *data_cpu)),
                     "sync_free_equals_listener_path": paths_equal,
                     "listener_iterations": len(collect.scores),
                     "eager_score": eager_score,
                     "no_host_sync_in_optimize": True,
                     "ok": (diff <= SOLVER_PARITY_TOL["params"]
                            and paths_equal
                            and len(collect.scores) == SOLVER_ITERS)}
        out[algo]["ok"] = out[algo]["ok"] and \
            out[algo]["score_card"] < out[algo]["score_start"]
    # Hessian-free through matmul_f32's bf16 product: double backward
    # through _Bf16ProductF32 on the card (torch.mm out_dtype), a
    # float32 product of the bf16 values on the CPU
    cpu = MultiLayerNetwork(solver_mlp_conf("hessian_free", "bfloat16"),
                            device="cpu")
    card = MultiLayerNetwork.from_config_json(
        cpu.to_json(), params=cpu.params(), device=device)
    data_cpu = (torch.from_numpy(xb), torch.from_numpy(yb))
    data = tuple(a.to(device) for a in data_cpu)
    v = torch.from_numpy(rng.normal(size=cpu.num_params()).astype(
        np.float32))
    hvps = []
    for net, d, vv in ((card, data, v.to(device)), (cpu, data_cpu, v)):
        _, x0, loss = net_solver(net)
        xv = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(xv, *d), xv, create_graph=True)
        (hv,) = torch.autograd.grad(g, xv, grad_outputs=vv)
        hvps.append(hv.detach().cpu())
    hvp_rel = max_err(*hvps) / float(hvps[1].abs().max())
    kw = {"initial_lambda": HF_PARITY_LAMBDA}
    solver, x0, loss = net_solver(card, kw)
    cpu_solver, cx0, cpu_loss = net_solver(cpu, kw)
    _, score = solver.optimize(x0, *data)
    _, ref_score = cpu_solver.optimize(cx0, *data_cpu)
    start = float(cpu_loss(cx0, *data_cpu))
    score_rel = abs(score - ref_score) / abs(ref_score)
    bf16 = {"bf16_product": bf16_product_route(device),
            "hvp_max_rel_diff": hvp_rel, "score_start": start,
            "score_card": score, "score_cpu": ref_score,
            "score_rel_diff": score_rel,
            "ok": (hvp_rel <= SOLVER_PARITY_TOL["bf16_hvp_rel"]
                   and score_rel <= SOLVER_PARITY_TOL["bf16_score_rel"]
                   and np.isfinite(score) and score < start)}
    return {"dtype": "float32", "iterations": SOLVER_ITERS, "batch": 64,
            "hf_initial_lambda": HF_PARITY_LAMBDA, "optimizers": out,
            "hessian_free_bf16": bf16, "tolerances": SOLVER_PARITY_TOL,
            "ok": all(m["ok"] for m in out.values()) and bf16["ok"]}


# -------------------------------------------------------------------- DBN
DBN_BATCH = 2048
DBN_ITERS = 5
DBN_FITS = 12
DBN_GROUPS = {"cublas_gemm": ("nvjet", "gemm", "Kernel2"),
              "casts_copies": "copy_kern",
              "foreach_updater": "multi_tensor_apply",
              "rng": ("bernoulli", "philox", "distribution"),
              "elementwise": "elementwise_kernel", "reduce": "reduce_kernel"}


def dbn_conf():
    """BASELINE config 4 (bench.py:241-256): 784-1024-512-10, sigmoid,
    RBM CD-1 on layers 0 and 1, softmax + mcxent, iteration gradient
    descent x 5, lr 0.05, bf16 products, batch 2048, pretraining on."""
    return (NeuralNetConfiguration.builder()
            .lr(0.05).n_in(784).activation_function("sigmoid")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(DBN_ITERS).batch_size(DBN_BATCH)
            .compute_dtype("bfloat16")
            .list(3).hidden_layer_sizes([1024, 512])
            .override(0, layer="rbm", k=1)
            .override(1, layer="rbm", k=1)
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=10)
            .pretrain(True).build())


def dbn_recon_errors(net, x):
    """Mean squared reconstruction error of each RBM on its input."""
    errs = []
    with torch.no_grad():
        cur = x
        for layer in net.layers[:-1]:
            p = layer.param_dict()
            errs.append(float(torch.square(layer.reconstruct(p, cur)
                                           - cur).mean()))
            cur = layer.activate(p, cur)
    return errs


def phase_dbn(device, seed):
    """The DBN's main path: fit() = layer-wise CD-1 pretraining of both
    RBMs (each a sync-free Solver of 5 iterations) then 5 backprop steps
    of the whole stack; one warm-up fit, DBN_FITS timed fits (samples/s
    counted as bench.py counts them: fits x batch x 5 x 3 / window), one
    fit under set_sync_debug_mode("error"), then Evaluation on 2048
    held-out rows and one fit profiled."""
    x_np, y_np = synthetic_mnist(2 * DBN_BATCH, seed=seed)
    x = torch.from_numpy(x_np[:DBN_BATCH]).to(device)
    y = torch.from_numpy(y_np[:DBN_BATCH]).to(device)
    net = MultiLayerNetwork(dbn_conf(), device=device)
    recon_before = dbn_recon_errors(net, x)
    score_before = net.score(x, y)
    t0 = time.perf_counter()
    net.fit(x, y)  # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    score_first = net.score(x, y)
    t0 = time.perf_counter()
    for _ in range(DBN_FITS):
        net.fit(x, y)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    samples = DBN_FITS * DBN_BATCH * DBN_ITERS * 3
    torch.cuda.set_sync_debug_mode("error")
    try:
        net.fit(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    score_last = net.score(x, y)
    recon_after = dbn_recon_errors(net, x)
    ev = Evaluation()
    ev.eval(y_np[DBN_BATCH:], net.output(x_np[DBN_BATCH:]))
    profile = device_profile(lambda: net.fit(x, y), iters=2,
                             groups=DBN_GROUPS)
    scores = [score_before, score_first, score_last]
    ok = (all(np.isfinite(scores + recon_before + recon_after))
          and score_last < score_before)
    return {"card": nvidia_smi(), "params": net.num_params(),
            "batch": DBN_BATCH, "iterations": DBN_ITERS,
            "compute_dtype": "bfloat16", "fits_timed": DBN_FITS,
            "warmup_fit_s": warmup_s, "window_s": window,
            "ms_per_fit": window * 1e3 / DBN_FITS,
            "samples_per_s": samples / window,
            "samples_counted_as": "fits x batch x iterations x 3 phases",
            "recon_error_before": recon_before,
            "recon_error_after": recon_after,
            "finetune_score": {"before": score_before,
                               "after_first_fit": score_first,
                               "last": score_last},
            "fits": DBN_FITS + 2, "eval_rows": DBN_BATCH,
            "accuracy": ev.accuracy(), "no_host_sync_in_fit": True,
            "fit_profile": profile, "ok": ok}


# ------------------------------------------------ solvers over attention
def phase_solver_attention(device, seed):
    """The attention stack (BASELINE widths, bf16 products, batch 1024)
    trained by conjugate_gradient and by lbfgs, two fit() calls of
    SOLVER_ITERS iterations each (the sync-free solver path; the second
    timed): per iteration one gradient (K1 with its lse, then K2 and K3)
    and num_line_search_iterations trials (K1 without lse), all run."""
    batch = ML_TRAIN["attention"][0]
    x_np, y_np = synthetic_mnist(batch, seed=seed + 7)
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np).to(device)
    out, total = {}, {k: 0 for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}
    for algo in ("conjugate_gradient", "lbfgs"):
        conf = attention_conf("bfloat16")
        for c in conf.confs:
            c.optimization_algo = algo
            c.num_iterations = SOLVER_ITERS
        net = MultiLayerNetwork(conf, device=device)
        trials = conf.confs[-1].num_line_search_iterations
        before = net.score(x, y)
        torch.cuda.synchronize()
        reset_flash_counts()
        net.fit(x, y)  # the first fit also builds the solver
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        net.fit(x, y)
        end.record()
        torch.cuda.synchronize()
        launches = flash_counts()
        ms = start.elapsed_time(end)
        after = net.score(x, y)
        gradients = 2 * SOLVER_ITERS
        want = {"flash_fwd": gradients * (1 + trials),
                "flash_bwd_dq": gradients, "flash_bwd_dkv": gradients}
        for k in total:
            total[k] += launches[k]
        out[algo] = {"fits": 2, "iterations_per_fit": SOLVER_ITERS,
                     "line_search_trials": trials,
                     "loss_first": before, "loss_last": after,
                     "ms_per_iteration": ms / SOLVER_ITERS,
                     "loss_evaluations_per_iteration": 1 + trials,
                     "launches": launches, "launches_expected": want,
                     "ok": (launches == want and np.isfinite(after)
                            and after < before)}
    return {"batch": batch, "compute_dtype": "bfloat16", "models": out,
            "launches": total,
            "ok": all(m["ok"] for m in out.values())}


# ------------------------------------------- checkpoints and the guardian
#: where the checkpoint phases write (inside the checkout's git-ignored
#: build directory; removed when the phases end)
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
#: the resume drill: BASELINE config 1, 16 batches of 4096, 2 epochs,
#: preempted after batch 10 and again after batch 21 (total)
RESUME_POLICY = {"check_every": 4, "snapshot_every": 8}
RESUME_EVERY, RESUME_KEEP, RESUME_STOPS = 4, 3, (10, 11)
#: the guardian's clean-overhead runs check and snapshot never
QUIET_POLICY = {"check_every": 10 ** 9, "snapshot_every": 10 ** 9}
#: bench.py's Iris recovery drill: one poisoned batch of 24 in 150
IRIS_BATCH, IRIS_STEPS, IRIS_POISONED = 24, 150, 7
#: the persistent-NaN schedule: 6 clean batches, then NaN to the end
PERSIST_CLEAN, PERSIST_BATCHES = 6, 16
PERSIST_POLICY = {"check_every": 2, "snapshot_every": 4,
                  "max_skips_per_window": 2, "max_rollbacks": 2}
#: the ladder's events are compared without their (NaN) scores
EVENT_SCORE_KEYS = ("score", "last_score", "best_recent_score")


def tree_diff(a, b, path="") -> dict:
    """{path: max |a - b|} over every tensor leaf of two trees (dicts,
    NamedTuples) whose leaves differ in a bit, compared on the host;
    dtype or shape differences are reported as inf."""
    if hasattr(a, "_fields"):
        a, b = a._asdict(), b._asdict()
    if isinstance(a, dict):
        out = {}
        for k in a:
            out.update(tree_diff(a[k], b[k], f"{path}/{k}"))
        return out
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return {path: float("inf")}
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    if torch.equal(a, b):
        return {}
    return {path: float((a.double() - b.double()).abs().max())}


def net_state(net) -> dict:
    return {"params": net.param_table, "updater": net._updater_state}


def bitwise_diff(a, b) -> dict:
    """The leaves of two networks that differ (empty when bit-equal), and
    their iteration counts."""
    diff = tree_diff(net_state(a), net_state(b))
    if a._iteration_count != b._iteration_count:
        diff["iteration_count"] = abs(a._iteration_count
                                      - b._iteration_count)
    return diff


class PreemptAt:
    """A listener that asks the fit in progress for a preemption after
    its `at`-th batch."""

    def __init__(self, at: int):
        self.at, self.count = at, 0

    def iteration_done(self, model, iteration, score):
        self.count += 1
        if self.count == self.at:
            model.guard.request_preemption()


class PreemptingSaver:
    """A ShardedModelSaver that asks for a preemption once it has
    autosaved position `at` (fit_scan calls no listener between
    epochs), so the flush comes at the next epoch's tick."""

    def __init__(self, saver, at: int):
        self.saver, self.at = saver, at

    def save(self, network, **kw):
        path = self.saver.save(network, **kw)
        if kw.get("iterator_position") == self.at:
            network.guard.request_preemption()
        return path

    def flush(self, timeout=None):
        self.saver.flush(timeout)


def timed_ms(fn):
    """(result, ms) of fn on the host clock, the device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mlp_batches(seed):
    """BASELINE config 1's batches on the host: (batch, n_batches, x, y)."""
    batch, n_batches, _ = ML_TRAIN["mlp"]
    x_np, y_np = synthetic_mnist(batch * n_batches, seed=seed)
    return batch, n_batches, x_np, y_np


def phase_checkpoint(device, seed):
    """BASELINE config 1 at full width after 2 fit steps: a
    ShardedModelSaver step written from the card restores on the CPU,
    and one written from the CPU restores on the card, every leaf, the
    counts, the cursor and the metadata bit-equal; a bf16 leaf (NaN and
    inf patterns included) round-trips bit for bit; a step without its
    COMMITTED marker is invisible; a flipped byte raises
    CorruptShardError; DefaultModelSaver / load_checkpoint round-trip."""
    from deeplearning4j_tpu_torch.checkpoint import (
        CorruptShardError, ShardedModelSaver, list_steps, load_tree,
        restore_network, write_checkpoint)
    from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
    from deeplearning4j_tpu_torch.scaleout.checkpoint import (
        DefaultModelSaver, load_checkpoint)

    batch = ML_TRAIN["mlp"][0]
    x_np, y_np = synthetic_mnist(2 * batch, seed=seed + 11)
    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    for i in range(2):
        net.fit(x_np[i * batch:(i + 1) * batch],
                y_np[i * batch:(i + 1) * batch])
    meta = {"epoch": 0, "epoch_batch": 2, "save_kind": "autosave"}
    out = {"card": nvidia_smi(), "params": net.num_params()}

    root = str(CKPT_DIR / "card")
    saver = ShardedModelSaver(root, keep=3)
    for position in (1, 2):  # the first allocates pinned buffers
        torch.cuda.synchronize()
        saver.save(net, iterator_position=position, metadata=meta)
        saver.flush()
    rec = saver.writer.stats()
    saver.close()
    out["saves"] = [save_record(h) for h in rec["history"]]
    out["bytes_per_checkpoint"] = rec["bytes_last"]
    (cpu, info), out["restore_ms_to_cpu"] = timed_ms(
        lambda: restore_network(root, device="cpu"))
    diffs = {"card_to_cpu": bitwise_diff(cpu, net)}
    cursor_ok = (info["iterator_position"] == 2 and info["step"] == 2
                 and info["metadata"] == meta)

    cpu_root = str(CKPT_DIR / "cpu")
    with ShardedModelSaver(cpu_root) as cpu_saver:
        cpu_saver.save(cpu, iterator_position=3, metadata=meta, wait=True)
    (back, info2), out["restore_ms_to_card"] = timed_ms(
        lambda: restore_network(cpu_root, device=device))
    diffs["cpu_to_card"] = bitwise_diff(back, cpu)
    cursor_ok &= info2["iterator_position"] == 3 and info2["metadata"] == meta

    npz = str(CKPT_DIR / "model.ckpt")
    _, out["npz_save_ms"] = timed_ms(lambda: DefaultModelSaver(
        npz, keep_old=False).save(net, iterator_position=2, metadata=meta))
    (loaded, info3), out["npz_load_ms_to_card"] = timed_ms(
        lambda: load_checkpoint(npz, device=device))
    diffs["npz"] = bitwise_diff(loaded, net)
    cursor_ok &= info3["iterator_position"] == 2

    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(-(1 << 15), 1 << 15, (257, 129), generator=gen,
                         device=device, dtype=torch.int32).to(torch.int16)
    bits[0, :3] = torch.tensor([0x7FC0, 0x7F80, -128], dtype=torch.int16)
    bf_root = str(CKPT_DIR / "bf16")
    write_checkpoint(bf_root, 1, {"w": bits.view(torch.bfloat16)})
    got = load_tree(bf_root)[0]["w"]
    bf16_ok = (got.dtype == torch.bfloat16
               and torch.equal(got.view(torch.int16), bits.cpu()))

    step_dir = write_checkpoint(root, 9, {"w": bits.view(torch.bfloat16)})
    os.remove(os.path.join(step_dir, ckfmt.MARKER))
    try:
        load_tree(root, 9)
        uncommitted_ok = False
    except FileNotFoundError:
        uncommitted_ok = 9 not in list_steps(root)
    victim = os.path.join(root, ckfmt.step_dir_name(2),
                          "params__0__W.s00.npy")
    with open(victim, "r+b") as f:
        f.seek(-7, os.SEEK_END)
        byte = f.read(1)
        f.seek(-7, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        restore_network(root, device=device)
        corrupt_ok = False
    except CorruptShardError as e:
        corrupt_ok = "params/0/W" in str(e)
    out.update({"bitwise_diffs": diffs, "cursor_and_metadata_equal":
                bool(cursor_ok), "bf16_round_trip": bool(bf16_ok),
                "uncommitted_invisible": bool(uncommitted_ok),
                "flipped_byte_refused": bool(corrupt_ok)})
    out["ok"] = (not any(diffs.values()) and cursor_ok and bf16_ok
                 and uncommitted_ok and corrupt_ok)
    return out


def save_record(h) -> dict:
    """One save of an AsyncCheckpointWriter's history in ms: what the fit
    thread paid (the wait for a slot, the snapshot, of it the pinned
    allocation; their sum the stall) and the writer thread's write."""
    return {"step": h["step"], "wait_ms": h["wait_s"] * 1e3,
            "snapshot_ms": h["snapshot_s"] * 1e3,
            "alloc_ms": h["alloc_s"] * 1e3,
            "stall_ms": (h["wait_s"] + h["snapshot_s"]) * 1e3,
            "write_ms": h["write_s"] * 1e3}


def save_summary(saves) -> dict:
    """Median and max of each ms field over a list of save records; the
    snapshot median of the saves that allocated nothing."""
    out = {"saves": len(saves),
           "allocating_saves": sum(s["alloc_ms"] > 0 for s in saves)}
    for key in ("wait_ms", "snapshot_ms", "alloc_ms", "stall_ms",
                "write_ms"):
        vals = [s[key] for s in saves]
        out[key] = {"median": float(np.median(vals)), "max": max(vals)}
    warm = [s["snapshot_ms"] for s in saves if s["alloc_ms"] == 0]
    out["snapshot_ms_reused_buffers"] = (
        {"median": float(np.median(warm)), "max": max(warm)} if warm
        else None)
    return out


def count_syncs(fn) -> int:
    """fn() under set_sync_debug_mode("warn"): the number of
    synchronizing CUDA operations it made on this thread. The notice
    torch gives once a process, at the first switch to a debug mode
    ("Synchronization debug mode is a prototype feature"), is not one."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def autosave_syncs(device, x, y, batch) -> dict:
    """Host syncs of autosaving fit_scan epochs (checkpoint_every=1, 2
    epochs, 2 saves): unguarded under set_sync_debug_mode("error"),
    raising if a snapshot synchronises; guarded (never checking) under
    "warn", where each save reads the guardian's two counters for its
    metadata, as the JAX package's does, and nothing else may sync."""
    from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
    from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy

    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    net.fit_scan(x, y, batch, sync=False)  # warm: the updater state made
    with ShardedModelSaver(str(CKPT_DIR / "sync_u")) as saver:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            net.fit_scan(x, y, batch, epochs=2, sync=False,
                         checkpoint_every=1, saver=saver)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        saves_u = saver.writer.stats()["saves"]
    with ShardedModelSaver(str(CKPT_DIR / "sync_g")) as saver:
        torch.cuda.synchronize()
        syncs = count_syncs(lambda: net.fit_scan(
            x, y, batch, epochs=2, sync=False, checkpoint_every=1,
            saver=saver, guardian=GuardianPolicy(**QUIET_POLICY)))
        saves_g = saver.writer.stats()["saves"]
    return {"unguarded_saves_under_error_mode": saves_u,
            "guarded_saves": saves_g, "guarded_syncs": syncs,
            "ok": saves_u == 2 and saves_g == 2 and syncs == 2 * saves_g}


def resume_fit(device, x_np, y_np, batch, root, stops):
    """BASELINE config 1 fitted 2 epochs over a DeviceFeed, guarded and
    autosaving; preempted after each count of `stops` batches and
    restored from the latest committed step by restore_network, then
    finished. Returns (net, record)."""
    from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                     latest_step,
                                                     restore_network)
    from deeplearning4j_tpu_torch.datasets import DeviceFeed
    from deeplearning4j_tpu_torch.optimize.guardian import (
        GuardianPolicy, TrainingPreempted)

    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    start, skip, epochs = {}, 0, 2
    rec = {"preempted_at": [], "restore_ms": [], "saves": []}
    max_in_flight = 0
    for stop in (*stops, None):
        feed = DeviceFeed(ListDataSetIterator(DataSet(x_np, y_np), batch),
                          device=device)
        feed.fast_forward(skip)
        net.set_listeners([PreemptAt(stop)] if stop else [])
        saver = ShardedModelSaver(root, keep=RESUME_KEEP)
        t0 = time.perf_counter()
        try:
            net.fit(feed, epochs=epochs, saver=saver,
                    guardian=GuardianPolicy(**RESUME_POLICY),
                    checkpoint_every=RESUME_EVERY, **start)
            preempted = None
        except TrainingPreempted as e:
            preempted = e
        torch.cuda.synchronize()
        rec.setdefault("fit_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        stats = saver.writer.stats()
        saver.close()
        max_in_flight = max(max_in_flight, stats["max_in_flight"])
        rec["saves"] += [save_record(h) for h in stats["history"]]
        if preempted is None:
            break
        committed = latest_step(root) == preempted.position
        rec["preempted_at"].append({"position": preempted.position,
                                    "committed": committed})
        (net, info), ms = timed_ms(
            lambda: restore_network(root, device=device))
        rec["restore_ms"].append(ms)
        meta = info["metadata"]
        start = {"start_position": info["iterator_position"],
                 "start_epoch": meta["epoch"],
                 "start_epoch_batch": meta["epoch_batch"]}
        skip, epochs = meta["epoch_batch"], 2 - meta["epoch"]
    rec["max_in_flight"] = max_in_flight
    rec["bytes_per_checkpoint"] = stats.get("bytes_last")
    rec["save_summary"] = save_summary(rec["saves"])
    return net, rec


def phase_resume(device, seed):
    """BASELINE config 1 at full width (bench.py:79-96), bf16 products,
    16 batches of 4096 through a DeviceFeed, 2 epochs, guarded, autosave
    every 4 batches (ShardedModelSaver, keep 3). Run A uninterrupted;
    run B preempted after batch 10 and after batch 21, each time
    restored on the card and resumed (start_* and fast_forward): A and B
    end bit-equal. Then the guarded fit_scan, checkpoint_every=1
    (epochs), preempted at epoch 2 and resumed the same way."""
    from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                     restore_network)
    from deeplearning4j_tpu_torch.optimize.guardian import (
        GuardianPolicy, TrainingPreempted)

    batch, n_batches, x_np, y_np = mlp_batches(seed)
    net_a, rec_a = resume_fit(device, x_np, y_np, batch,
                              str(CKPT_DIR / "run_a"), ())
    net_b, rec_b = resume_fit(device, x_np, y_np, batch,
                              str(CKPT_DIR / "run_b"), RESUME_STOPS)
    fit_diff = bitwise_diff(net_b, net_a)
    want_stops = [{"position": 10, "committed": True},
                  {"position": 21, "committed": True}]

    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np).to(device)
    scan_a = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    with ShardedModelSaver(str(CKPT_DIR / "scan_a")) as saver:
        scan_a.fit_scan(x, y, batch, epochs=4, checkpoint_every=1,
                        saver=saver, guardian=GuardianPolicy(
                            **RESUME_POLICY))
    scan_b = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    root = str(CKPT_DIR / "scan_b")
    with ShardedModelSaver(root) as saver:
        try:
            scan_b.fit_scan(x, y, batch, epochs=4, checkpoint_every=1,
                            saver=PreemptingSaver(saver, 1),
                            guardian=GuardianPolicy(**RESUME_POLICY))
            scan_stop = None
        except TrainingPreempted as e:
            scan_stop = e.position
    (scan_b, info), scan_restore_ms = timed_ms(
        lambda: restore_network(root, device=device))
    with ShardedModelSaver(root) as saver:
        scan_b.fit_scan(x, y, batch, epochs=4 - info["iterator_position"],
                        checkpoint_every=1, saver=saver,
                        guardian=GuardianPolicy(**RESUME_POLICY),
                        start_position=info["iterator_position"])
    scan_diff = bitwise_diff(scan_b, scan_a)
    loss = scan_a.score(x_np[:batch], y_np[:batch])
    syncs = autosave_syncs(device, x, y, batch)
    ok = (not fit_diff and rec_b["preempted_at"] == want_stops
          and not scan_diff and scan_stop == 2 and bool(np.isfinite(loss))
          and syncs["ok"])
    return {"card": nvidia_smi(), "params": net_a.num_params(),
            "batch": batch, "batches": n_batches, "epochs": 2,
            "policy": RESUME_POLICY, "checkpoint_every": RESUME_EVERY,
            "run_a": rec_a, "run_b": rec_b,
            "fit_bitwise_diff": fit_diff,
            "fit_scan": {"preempted_at_epoch": scan_stop,
                         "restore_ms": scan_restore_ms,
                         "bitwise_diff": scan_diff},
            "score_after_fit_scan": loss, "autosave_syncs": syncs,
            "ok": ok}


def guardian_overhead(device, seed):
    """(a) of the guardian phase: guarded (never checking) against
    unguarded on BASELINE config 1; see phase_guardian."""
    from deeplearning4j_tpu_torch.optimize.guardian import (GuardianPolicy,
                                                            guardian_state)

    batch, n_batches, x_np, y_np = mlp_batches(seed + 3)
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np).to(device)
    conf = mlp_conf("bfloat16")
    fit_u, fit_g = (MultiLayerNetwork(conf, device=device) for _ in "ug")
    fit_u.fit(ListDataSetIterator(DataSet(x_np, y_np), batch))
    fit_g.fit(ListDataSetIterator(DataSet(x_np, y_np), batch),
              guardian=GuardianPolicy(**QUIET_POLICY))
    fit_diff = bitwise_diff(fit_g, fit_u)
    scan_u, scan_g = (MultiLayerNetwork(conf, device=device) for _ in "ug")
    runs = {"unguarded": [], "guarded": []}
    for name in ("unguarded", "guarded", "guarded", "unguarded"):
        net, kw = ((scan_u, {}) if name == "unguarded" else
                   (scan_g, {"guardian": GuardianPolicy(**QUIET_POLICY)}))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        net.fit_scan(x, y, batch, sync=False, **kw)
        end.record()
        torch.cuda.synchronize()
        runs[name].append(start.elapsed_time(end) / n_batches)
    scan_diff = bitwise_diff(scan_g, scan_u)
    torch.cuda.set_sync_debug_mode("error")
    try:
        scan_g.fit_scan(x, y, batch, sync=False,
                        guardian=GuardianPolicy(**QUIET_POLICY))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms_u = sum(runs["unguarded"]) / 2
    ms_g = sum(runs["guarded"]) / 2
    gstate = guardian_state(device=device)
    xb, yb = x[:batch], y[:batch]
    prof_u = device_profile(lambda: scan_u._train_step(xb, yb), iters=3,
                            groups=ML_GROUPS)
    prof_g = device_profile(
        lambda: scan_g._guarded_train_step(xb, yb, None, gstate), iters=3,
        groups=ML_GROUPS)
    return {"fit_bitwise_diff": fit_diff, "fit_scan_bitwise_diff": scan_diff,
            "ms_per_step_runs": runs, "ms_per_step_unguarded": ms_u,
            "ms_per_step_guarded": ms_g,
            "overhead_pct": (ms_g - ms_u) / ms_u * 100.0,
            "kernels_per_step_unguarded": prof_u.get("kernels_per_call"),
            "kernels_per_step_guarded": prof_g.get("kernels_per_call"),
            "device_ms_per_step_unguarded": prof_u.get("device_ms_per_call"),
            "device_ms_per_step_guarded": prof_g.get("device_ms_per_call"),
            "step_profile_unguarded": prof_u, "step_profile_guarded": prof_g,
            "no_host_sync_in_guarded_epoch": True,
            "ok": not fit_diff and not scan_diff}


def iris_conf():
    """bench.py's recovery-drill net: 4-8-3 tanh, SGD + momentum 0.5."""
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False).momentum(0.5)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def iris_stream(n_steps, seed=0):
    from deeplearning4j_tpu_torch.datasets import load_iris

    data = load_iris()
    ix, iy = np.asarray(data.features), np.asarray(data.labels)
    rng = np.random.RandomState(seed)
    sel = np.concatenate([rng.choice(len(ix), IRIS_BATCH, replace=False)
                          for _ in range(n_steps)])
    return ix, iy, ix[sel].copy(), iy[sel].copy()


def iris_drill(device):
    """(b): bench.py:405-450 on the card."""
    from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectGuardianEvents

    ix, iy, dx, dy = iris_stream(IRIS_STEPS)
    clean = MultiLayerNetwork(iris_conf(), device=device)
    clean.fit(ListDataSetIterator(DataSet(dx, dy), IRIS_BATCH))
    score_clean = clean.score(ix, iy)
    dx_bad = dx.copy()
    dx_bad[IRIS_POISONED * IRIS_BATCH:(IRIS_POISONED + 1) * IRIS_BATCH] = \
        np.nan
    ev = CollectGuardianEvents()
    faulty = MultiLayerNetwork(iris_conf(), device=device)
    faulty.fit(ListDataSetIterator(DataSet(dx_bad, dy), IRIS_BATCH),
               guardian=GuardianPolicy(check_every=4, snapshot_every=16,
                                       listeners=[ev]))
    finite = bool(torch.isfinite(faulty.params()).all())
    delta = abs(faulty.score(ix, iy) - score_clean)
    return {"steps": IRIS_STEPS, "poisoned_batch": IRIS_POISONED,
            "events": ev.kinds(), "params_finite": finite,
            "score_clean": score_clean, "score_delta": delta,
            "ok": finite and delta < 1e-3 and "skip" in ev.kinds()}


def nan_inputs(device, dtype, seed):
    """q, k, v at the attention stack's shape with a NaN query row, a
    NaN key row and an inf value row in three different sequences."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(1024, 28, 128, generator=gen, device=device
                           ).to(dtype) for _ in range(3))
    q[5, 3] = float("nan")
    k[9, 2] = float("nan")
    v[12, 4] = float("inf")
    return q, k, v


def kernels_on_nan(device, seed):
    """(c), kernels: K1 (bf16 wgmma, float32 scalar) and K2/K3 on the
    inputs of nan_inputs: non-finite exactly where their plain versions
    are; the finite parts within TOL / BWD_TOL."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = nan_inputs(device, dt, seed)
        o, lse = flash._flash_forward(q, k, v, False, True)
        ref_o, ref_lse = flash.flash_attention_ref(q, k, v, False, True)
        do = torch.randn_like(q)
        grads = flash._flash_backward(q, k, v, o, lse, do, False)
        refs = flash.flash_attention_bwd_ref(q, k, v, ref_o, ref_lse, do,
                                             False)
        row = {}
        for name, got, ref in (("out", o, ref_o), ("dq", grads[0], refs[0]),
                               ("dk", grads[1], refs[1]),
                               ("dv", grads[2], refs[2])):
            fin, ref_fin = torch.isfinite(got), torch.isfinite(ref)
            same = bool(torch.equal(fin, ref_fin))
            err = max_err(got[fin & ref_fin].float(),
                          ref[fin & ref_fin].float())
            scale = float(ref[ref_fin].float().abs().max())
            row[name] = {"nonfinite": int((~fin).sum()),
                         "plain_nonfinite": int((~ref_fin).sum()),
                         "same_positions": same, "max_abs_err": err,
                         "ok": same and err <= (TOL[dt] if name == "out"
                                                else BWD_TOL[dt] * scale)}
        out[str(dt).split(".")[-1]] = row
    torch.cuda.synchronize()
    return out, all(r["ok"] for d in out.values() for r in d.values())


def attention_nan_skip(device, seed):
    """(c), path: the attention stack (bf16, batch 1024) fits a clean
    batch, then a batch with a NaN row under the guardian: the step is
    skipped and params and updater state stay bit-unchanged; K1, K2 and
    K3 launched once a step, as on the multilayer path."""
    from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectGuardianEvents

    batch = ML_TRAIN["attention"][0]
    x_np, y_np = synthetic_mnist(2 * batch, seed=seed + 5)
    net = MultiLayerNetwork(attention_conf("bfloat16"), device=device)
    policy = GuardianPolicy(check_every=1)
    torch.cuda.synchronize()
    reset_flash_counts()
    net.fit(x_np[:batch], y_np[:batch], guardian=policy)
    before = {"params": {k: {n: p.detach().clone() for n, p in t.items()}
                         for k, t in net.param_table.items()},
              "updater": _clone_state(net._updater_state)}
    bad = x_np[batch:].copy()
    bad[17] = np.nan
    ev = CollectGuardianEvents()
    net.fit(bad, y_np[batch:], guardian=GuardianPolicy(check_every=1,
                                                        listeners=[ev]))
    torch.cuda.synchronize()
    launches = flash_counts()
    diff = tree_diff(net_state(net), before)
    want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    return {"batch": batch, "events": ev.kinds(),
            "bitwise_diff_across_skip": diff, "launches": launches,
            "launches_expected": want,
            "ok": not diff and ev.kinds() == ["skip"] and launches == want}


def _clone_state(state):
    from deeplearning4j_tpu_torch.optimize.updater import UpdaterState

    return {k: UpdaterState({n: t.clone() for n, t in s.hist.items()},
                            {n: t.clone() for n, t in s.velocity.items()},
                            s.iteration.clone())
            for k, s in state.items()}


def persistent_nan(device):
    """(d): 6 clean batches then NaN to the end, on `device`: the
    events (kind, step, detail but scores) and the abort report; the
    network left bit-equal to the last-good snapshot."""
    from deeplearning4j_tpu_torch.optimize.guardian import (GuardianAbort,
                                                            GuardianPolicy)
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectGuardianEvents

    _, _, dx, dy = iris_stream(PERSIST_BATCHES, seed=2)
    dx[PERSIST_CLEAN * IRIS_BATCH:] = np.nan
    net = MultiLayerNetwork(iris_conf(), device=device)
    ev = CollectGuardianEvents()
    report, at_last_good = None, False
    try:
        net.fit(ListDataSetIterator(DataSet(dx, dy), IRIS_BATCH),
                guardian=GuardianPolicy(listeners=[ev], **PERSIST_POLICY))
    except GuardianAbort as e:
        report = {k: e.report[k] for k in ("steps", "skipped", "rollbacks",
                                           "lr_scale", "reason")}
        params, state = e.last_good
        at_last_good = not tree_diff(net_state(net),
                                     {"params": params, "updater": state})
    events = [[e.kind, e.step, {k: v for k, v in e.info.items()
                                if k not in EVENT_SCORE_KEYS}]
              for e in ev.events]
    return events, report, at_last_good, net.params().detach().cpu()


def phase_guardian(device, seed):
    """bench.py:364 bench_guardian on the card: (a) clean guarded vs
    unguarded runs of BASELINE config 1 (fit and fit_scan bit-equal; ms
    a step; kernels a step by torch.profiler; a guarded epoch under
    set_sync_debug_mode("error")); (b) the Iris NaN-recovery drill;
    (c) a NaN row on the attention stack skipped, K1-K3 on non-finite
    inputs against their plain versions; (d) a persistent-NaN schedule:
    rollbacks at lr_scale 0.5 then 0.25, then GuardianAbort with the
    network on the last-good snapshot, the events as the CPU run's."""
    overhead = guardian_overhead(device, seed)
    iris = iris_drill(device)
    kernels, kernels_ok = kernels_on_nan(device, seed)
    skip = attention_nan_skip(device, seed)
    card = persistent_nan(device)
    cpu = persistent_nan("cpu")
    rollbacks = [e[2].get("lr_scale") for e in card[0]
                 if e[0] == "rollback"]
    persist = {"events": card[0], "cpu_events": cpu[0],
               "report": card[1], "cpu_report": cpu[1],
               "rollback_lr_scales": rollbacks,
               "network_at_last_good": card[2],
               "params_max_abs_diff_vs_cpu": max_err(card[3], cpu[3]),
               "ok": (card[0] == cpu[0] and card[1] == cpu[1]
                      and card[1] is not None and rollbacks == [0.5, 0.25]
                      and card[2])}
    return {"card": nvidia_smi(), "overhead": overhead, "iris": iris,
            "nan_kernels": kernels, "nan_kernels_ok": kernels_ok,
            "attention_skip": skip, "persistent_nan": persist,
            "launches": skip["launches"],
            "ok": (overhead["ok"] and iris["ok"] and kernels_ok
                   and skip["ok"] and persist["ok"])}


#: where the readers, cli and lstm phases write (removed afterwards)
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
#: synthetic_mnist rows of the readers / cli phases' CSV (BASELINE
#: config 1's batch 4096, two batches an epoch)
READER_ROWS = 8192
#: rows a batch of the async iterator's queue-only drain, and its epochs
QUEUE_BATCH, QUEUE_EPOCHS = 1024, 3
#: the LSTM's card-vs-CPU shapes, limits, and the full-width run: bytes
#: (n_in = hidden = n_out = 256), T 128, B 64, bf16 products, SGD
LSTM_PARITY = {"d": 32, "t": 16, "b": 4}
LSTM_PARITY_TOL = {"outputs": 1e-5, "params": 1e-4}
LSTM_FULL = {"d": 256, "t": 128, "b": 64, "lr": 0.02, "steps": 60,
             "beam": 5, "beam_steps": 20}
#: the reference's LSTMTest trains on "hello world"
LSTM_PHRASE = b"hello world "


def write_mnist_csv(path, seed, rows):
    """synthetic_mnist rows with an integer label column; `%.9g` gives
    back every float32 bit for bit."""
    x, y = synthetic_mnist(rows, seed=seed)
    np.savetxt(path, np.hstack([x, y.argmax(1)[:, None]]), delimiter=",",
               fmt="%.9g")
    return x, y


class FailsAfter(DataSetIterator):
    """A list iterator whose second batch raises (a shard that cannot be
    read mid-epoch)."""

    def __init__(self, data, batch):
        self.inner = ListDataSetIterator(data, batch)
        super().__init__(batch, data.num_examples)
        self.served = 0

    def input_columns(self):
        return self.inner.input_columns()

    def total_outcomes(self):
        return self.inner.total_outcomes()

    def reset(self):
        self.inner.reset()
        self.served = 0

    def has_next(self):
        return self.inner.has_next()

    def next(self, num=None):
        self.served += 1
        if self.served == 2:
            raise OSError("shard 2 of the stream is unreadable")
        return self.inner.next(num)


def phase_readers(device, seed):
    """BASELINE config 1 fed from a CSV file: the native library built
    under build/native/; a CSV of READER_ROWS synthetic_mnist rows read
    by np.loadtxt and by the native read_csv (rows/s; both bit-equal to
    the rows written); CSVDataSetIterator -> AsyncDataSetIterator ->
    DeviceFeed -> fit for 2 epochs bit-equal to the same rows through
    ListDataSetIterator -> DeviceFeed -> fit; the async iterator's
    batches/s alone; fit samples/s through the async path (CSV source,
    and in-memory source) against the list path; a producer error raised
    mid-stream relayed to fit."""
    from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                                   CSVDataSetIterator,
                                                   DeviceFeed)
    from deeplearning4j_tpu_torch.runtime import native_loader

    lib = native_loader.library_path()
    native_ok = (native_loader.native_available() and lib is not None
                 and lib.is_relative_to(native_loader.BUILD_ROOT))
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    csv = CLI_DIR / "mnist.csv"
    x, y = write_mnist_csv(csv, seed, READER_ROWS)
    data = np.hstack([x, y.argmax(1)[:, None].astype(np.float32)])
    loadtxt, loadtxt_ms = timed_ms(
        lambda: np.loadtxt(csv, delimiter=",", dtype=np.float32, ndmin=2))
    native, native_ms = timed_ms(lambda: native_loader.read_csv(str(csv)))
    parse_ok = (np.array_equal(loadtxt, data)
                and np.array_equal(native, data))

    batch = ML_TRAIN["mlp"][0]
    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    ref = net.clone()
    async_csv = AsyncDataSetIterator(
        CSVDataSetIterator(str(csv), batch, num_classes=10))
    feed = DeviceFeed(async_csv, device=device)
    _, async_ms = timed_ms(lambda: net.fit(feed, epochs=2))
    feed.close()
    _, list_ms = timed_ms(lambda: ref.fit(
        ListDataSetIterator(DataSet(x, y), batch), epochs=2))
    diff = bitwise_diff(net, ref)

    mem = net.clone()
    feed = DeviceFeed(AsyncDataSetIterator(
        ListDataSetIterator(DataSet(x, y), batch)), device=device)
    _, async_mem_ms = timed_ms(lambda: mem.fit(feed, epochs=2))
    feed.close()

    queue = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y),
                                                     QUEUE_BATCH))
    t0 = time.perf_counter()
    n_queued = 0
    for _ in range(QUEUE_EPOCHS):
        queue.reset()
        for ds in queue:
            n_queued += 1
    queue_s = time.perf_counter() - t0
    queue.close()

    failing = DeviceFeed(AsyncDataSetIterator(
        FailsAfter(DataSet(x, y), batch // 4)), device=device)
    try:
        net.fit(failing)
        relayed = None
    except OSError as e:
        relayed = str(e)
    failing.close()
    samples = 2e3 * READER_ROWS  # per ms -> per s
    return {"card": nvidia_smi(), "rows": READER_ROWS,
            "native_library": str(lib), "native_ok": native_ok,
            "csv_bytes": csv.stat().st_size,
            "rows_per_s": {"np_loadtxt": 1e3 * READER_ROWS / loadtxt_ms,
                           "native_read_csv": 1e3 * READER_ROWS / native_ms,
                           "csv_iterator_async": samples / async_ms},
            "parse_bit_equal": parse_ok,
            "async_vs_list_bitwise_diff": diff,
            "fit_samples_per_s": {"async_csv": samples / async_ms,
                                  "async_memory": samples / async_mem_ms,
                                  "list": samples / list_ms},
            "async_queue": {"batch": QUEUE_BATCH, "batches": n_queued,
                            "batches_per_s": n_queued / queue_s,
                            "mb_per_s": n_queued * QUEUE_BATCH * 794 * 4
                            / queue_s / 1e6},
            "relayed_error": relayed,
            "ok": (native_ok and parse_ok and not diff
                   and relayed == "shard 2 of the stream is unreadable"
                   and n_queued == QUEUE_EPOCHS * READER_ROWS
                   // QUEUE_BATCH)}


def run_cli(argv):
    """(rc, stdout, seconds) of one in-process CLI call."""
    from deeplearning4j_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue(), time.perf_counter() - t0


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


class FirstStep:
    """Records when the first training step of a fit returns (the card
    synchronised): time to first step from the CLI's start."""

    def __enter__(self):
        self.orig = MultiLayerNetwork._fit_supervised
        self.at = None
        orig = self.orig

        def timed(net, *args, **kwargs):
            out = orig(net, *args, **kwargs)
            if self.at is None:
                torch.cuda.synchronize()
                self.at = time.perf_counter()
            return out

        MultiLayerNetwork._fit_supervised = timed
        return self

    def __exit__(self, *exc):
        MultiLayerNetwork._fit_supervised = self.orig


def phase_cli(device, seed):
    """The command line on the card (python -m deeplearning4j_tpu_torch.cli,
    in-process): from a port-written init.ckpt of BASELINE config 1,
    `train --batch-size 4096 --epochs 2 --checkpoint-dir` leaves params
    bit-equal to the same fit called through the API; test, predict,
    eval --json and checkpoint inspect --json return 0 with the JAX
    CLI's shapes of output; 1 epoch then `--resume auto --epochs 2` is
    bit-equal to the 2-epoch run and extends the autosave numbering; the
    attention stack trains and tests through the CLI with K1-K3 counted
    (launches_by_path["cli"]); one subprocess `test` gives the
    in-process metrics. CLI wall time and time to first step."""
    from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                     list_steps)
    from deeplearning4j_tpu_torch.cli import _load_csv
    from deeplearning4j_tpu_torch.scaleout.checkpoint import (
        DefaultModelSaver, load_checkpoint)

    dev = torch.device(device).type
    csv = CLI_DIR / "mnist.csv"
    init = CLI_DIR / "init.ckpt"
    DefaultModelSaver(str(init)).save(
        MultiLayerNetwork(mlp_conf("bfloat16"), device=device))
    batch = ML_TRAIN["mlp"][0]
    common = ["-i", csv, "-m", init, "--device", dev, "--batch-size", batch]
    with FirstStep() as first:
        t0 = time.perf_counter()
        rc, out, train_s = run_cli(["train", *common, "-o",
                                    CLI_DIR / "m2.ckpt", "--epochs", 2,
                                    "--checkpoint-dir", CLI_DIR / "ck2"])
        first_step_s = first.at - t0 if first.at else None
    summary = last_json(out) if rc == 0 else None
    cli_net, _ = load_checkpoint(str(CLI_DIR / "m2.ckpt"), device=device)

    ref, _ = load_checkpoint(str(init), device=device)
    x, y = _load_csv(str(csv), 1, 10)
    saver = ShardedModelSaver(str(CLI_DIR / "ck_api"), keep=3)
    ref.fit(ListDataSetIterator(DataSet(x, y), batch), epochs=2,
            saver=saver, checkpoint_every=1)
    saver.close()
    train_diff = bitwise_diff(cli_net, ref)
    train_ok = (rc == 0 and not train_diff
                and sorted(summary) == ["saved", "score"]
                and list_steps(str(CLI_DIR / "ck2"))
                == list_steps(str(CLI_DIR / "ck_api")))

    outputs = {}
    rc_t, out, test_s = run_cli(["test", "-i", csv, "-m",
                                 CLI_DIR / "m2.ckpt", "--device", dev])
    metrics = last_json(out) if rc_t == 0 else None
    outputs["test"] = rc_t == 0 and sorted(metrics) == [
        "accuracy", "f1", "precision", "recall"]
    preds = CLI_DIR / "preds.txt"
    rc_p, out, predict_s = run_cli(["predict", "-i", csv, "-m",
                                    CLI_DIR / "m2.ckpt", "--device", dev,
                                    "--label-columns", 1, "-o", preds])
    ids = np.loadtxt(preds, dtype=np.int64) if rc_p == 0 else None
    outputs["predict"] = bool(rc_p == 0 and last_json(out) == {
        "saved": str(preds), "n": READER_ROWS}
        and ids.shape == (READER_ROWS,) and ids.min() >= 0
        and ids.max() < 10)
    rc_e, out, eval_s = run_cli(["eval", "-m", CLI_DIR / "ck2", "--data",
                                 csv, "--device", dev, "--json"])
    ev = last_json(out) if rc_e == 0 else None
    steps2 = list_steps(str(CLI_DIR / "ck2"))
    outputs["eval"] = (rc_e == 0 and sorted(ev) == sorted(
        ["f1", "accuracy", "precision", "recall", "n", "path", "step",
         "eval_seconds"]) and ev["step"] == steps2[-1]
        and ev["n"] == READER_ROWS)
    rc_i, out, _ = run_cli(["checkpoint", "inspect", CLI_DIR / "ck2",
                            "--json"])
    inspect = last_json(out) if rc_i == 0 else None
    outputs["inspect"] = (rc_i == 0 and sorted(inspect) == sorted(
        ["dir", "steps", "step", "saved_at", "mesh", "format_version",
         "iterator_position", "iteration_count", "metadata",
         "total_bytes", "n_leaves", "leaves"])
        and inspect["steps"] == steps2)

    rc1, _, _ = run_cli(["train", *common, "-o", CLI_DIR / "m1.ckpt",
                         "--epochs", 1, "--checkpoint-dir", CLI_DIR / "ck1"])
    steps1 = list_steps(str(CLI_DIR / "ck1"))
    rcr, out, resume_s = run_cli(["train", *common, "-o",
                                  CLI_DIR / "mr.ckpt", "--epochs", 2,
                                  "--checkpoint-dir", CLI_DIR / "ck1",
                                  "--resume", "auto"])
    lines = [json.loads(s) for s in out.strip().splitlines()] \
        if rcr == 0 else []
    resumed, _ = load_checkpoint(str(CLI_DIR / "mr.ckpt"), device=device)
    steps_after = list_steps(str(CLI_DIR / "ck1"))
    resume_diff = bitwise_diff(resumed, cli_net)
    resume_ok = (rc1 == 0 and rcr == 0 and not resume_diff
                 and lines[0]["step"] == steps1[-1]
                 and lines[-1]["resumed_from"] == steps1[-1]
                 and steps_after[-1] > steps1[-1])

    attn = CLI_DIR / "attention.json"
    attn.write_text(attention_conf("bfloat16").to_json())
    abatch = ML_TRAIN["attention"][0]
    torch.cuda.synchronize()
    reset_flash_counts()
    rc_a, out_a, attn_s = run_cli(["train", "-i", csv, "-m", attn,
                                   "--device", dev, "--batch-size", abatch,
                                   "--epochs", 1, "-o",
                                   CLI_DIR / "attention.ckpt"])
    rc_at, out_at, _ = run_cli(["test", "-i", csv, "-m",
                                CLI_DIR / "attention.ckpt", "--device", dev])
    torch.cuda.synchronize()
    launches = flash_counts()
    n_steps = READER_ROWS // abatch
    attn_ok = (rc_a == 0 and rc_at == 0
               and launches["flash_bwd_dq"] == n_steps
               and launches["flash_bwd_dkv"] == n_steps
               and launches["flash_fwd"] >= n_steps + 1)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "test", "-i",
         str(csv), "-m", str(CLI_DIR / "m2.ckpt"), "--device", dev],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(Path(__file__).resolve().parent))
    sub_s = time.perf_counter() - t0
    sub_ok = sub.returncode == 0 and last_json(sub.stdout) == metrics
    return {"card": nvidia_smi(), "batch": batch, "rows": READER_ROWS,
            "train": {"summary": summary, "bitwise_diff_api": train_diff,
                      "wall_s": train_s,
                      "time_to_first_step_s": first_step_s,
                      "steps": list_steps(str(CLI_DIR / "ck2"))},
            "metrics": metrics, "eval": ev, "outputs_ok": outputs,
            "wall_s": {"test": test_s, "predict": predict_s,
                       "eval": eval_s, "resume": resume_s,
                       "attention_train": attn_s,
                       "subprocess_test": sub_s},
            "resume": {"steps_first": steps1, "steps_after": steps_after,
                       "lines": lines,
                       "bitwise_diff_2_epochs": resume_diff},
            "attention": {"summary": last_json(out_a) if rc_a == 0
                          else None,
                          "metrics": last_json(out_at) if rc_at == 0
                          else None, "steps": n_steps},
            "subprocess": {"rc": sub.returncode, "same_metrics": sub_ok,
                           "stderr_tail": sub.stderr[-400:]},
            "launches": launches,
            "ok": (train_ok and all(outputs.values()) and resume_ok
                   and attn_ok and sub_ok)}


# ------------------------------------------------------------- pipeline
PIPE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_pipeline"
#: training rows and held-out rows of one synthetic_mnist draw
PIPE_ROWS, PIPE_HELD = 4096, 1024
#: 3 epochs at batch 1024 = 12 steps; an autosave every 4: commits 4, 8, 12
PIPE_EPOCHS, PIPE_EVERY = 3, 4
#: the eval gate's absolute f1 threshold
PIPE_THRESHOLD = 0.5
#: the announce line of `cli pipeline`, the JAX CLI's keys
PIPE_ANNOUNCE_KEYS = {"pipeline", "checkpoint_dir", "fleet", "status",
                      "incarnation"}


def pipeline_data(seed):
    """train.csv (4,096 rows) and held.csv (1,024 rows) with an integer
    label column, cut from one synthetic_mnist draw (one set of class
    templates); returns the paths and the arrays."""
    x, y = synthetic_mnist(PIPE_ROWS + PIPE_HELD, seed=seed)
    parts = {"train": (x[:PIPE_ROWS], y[:PIPE_ROWS]),
             "held": (x[PIPE_ROWS:], y[PIPE_ROWS:])}
    paths = {}
    for name, (xs, ys) in parts.items():
        paths[name] = PIPE_DIR / f"{name}.csv"
        np.savetxt(paths[name], np.hstack([xs, ys.argmax(1)[:, None]]),
                   delimiter=",", fmt="%.9g")
    return paths, parts


def metric_samples(text, prefix, label=None) -> dict:
    """{sample name: value} of a /metrics page's samples whose name
    starts with `prefix` (and whose labels hold `label`), buckets left
    out."""
    out = {}
    for ln in text.splitlines():
        if (ln.startswith(prefix) and "_bucket{" not in ln
                and (label is None or label in ln)):
            out[ln.split("{")[0].split(" ")[0]] = float(ln.split()[-1])
    return out


def output_logits(net, x) -> torch.Tensor:
    """The output layer's pre-activation (the logits under its softmax),
    float32 on the host."""
    x = net._tensor(x)
    n = len(net.layers) - 1
    with torch.no_grad():
        h = net._layer_input(n, net.feed_forward_fn(net.param_table,
                                                    x)[-2])
        z = net.layers[-1].pre_output(net.param_table[str(n)], h)
    return z.float().cpu()


def gate_rows(card_out, ref_logits) -> list:
    """Every held-out row whose class differs between the card's gate
    and the reference, as near_tie_record gives it: the reference's
    top logit and top-2 gap, and how far below the top each pick lies."""
    card = card_out.float().cpu().argmax(1)
    ref = ref_logits.argmax(1)
    return [near_tie_record(int(r), 0, ref_logits[r],
                            [int(card[r]), int(ref[r])])
            for r in torch.nonzero(card != ref).flatten().tolist()]


def telemetry_cost(device, x, y) -> dict:
    """What telemetry costs a training step: the attention stack (bf16,
    batch 1024) from the same weights, one net stepping with telemetry
    on and host spans traced, the other with telemetry killed. A step's
    host syncs (count_syncs) must be equal and the params bit-identical
    after the same 7 steps; ms a step each (median of 5, by the host
    clock around a synchronised step, not gated)."""
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.telemetry import trace as ttrace

    xb = torch.as_tensor(x, device=device)
    yb = torch.as_tensor(y, device=device)
    nets = {mode: MultiLayerNetwork(attention_conf("bfloat16"),
                                    device=device) for mode in ("on", "off")}
    syncs, ms = {}, {}
    for mode, net in nets.items():
        net.fit(xb, yb)  # warm: the updater state made
        telemetry.set_enabled(mode == "on")
        if mode == "on":
            ttrace.start_tracing()
        try:
            torch.cuda.synchronize()
            syncs[mode] = count_syncs(lambda: net.fit(xb, yb))
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(xb, yb)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[mode] = float(np.median(times))
        finally:
            telemetry.set_enabled(True)
            ttrace.stop_tracing()
    diff = bitwise_diff(nets["on"], nets["off"])
    return {"syncs_a_step": syncs, "step_ms": ms, "bitwise_diff": diff,
            "ok": syncs["on"] == syncs["off"] and not diff}


def live_group_members(pgid: int) -> list:
    """Pids of the live (not zombie) processes in process group `pgid`,
    read from /proc (an adopted replica is not this process's child, so
    nothing here reaps it)."""
    members = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat", "rb") as f:
                raw = f.read().decode("ascii", errors="replace")
        except OSError:
            continue
        rest = raw[raw.rindex(")") + 2:].split()
        if int(rest[2]) == pgid and rest[0] not in ("Z", "X", "x"):
            members.append(int(name))
    return members


def phase_pipeline(device, seed):
    """The train -> serve conveyor (deploy/controller.py, cli pipeline)
    over the attention stack at full width, bf16 products.

    (a) In process: `cli train` (batch 1024, 3 epochs = 12 steps, an
        autosave every 4 steps, --metrics-port 0, --trace) commits steps
        4, 8 and 12; then step 13 (step 12 with its output layer's
        weights negated) and step 14 (BASELINE config 1's MLP, trained
        one epoch) are committed into the same root. A
        DeploymentController (device cuda, eval gate on 1,024 held-out
        rows at f1 >= 0.5, a /predict probe of 4 rows, a state dir, a
        status port) drives a Fleet of two serve_network replicas of the
        stack on threads of this process: step 14 passes the gate and
        fails its canary (another architecture), step 13 fails the
        gate, step 12 is promoted, then nothing is left. K1-K3 counted
        from `cli train` to the last cycle, before any reference forward
        (the "pipeline" path). Then: every replica's /stats and /readyz
        name step 12, their /predict within the bf16 tolerance of step
        12 restored on the card, the gate's classes against a float32
        CPU gate (every differing row a near-tie), the status port's
        dl4j_pipeline_* counters, the trainer's /metrics (steps, commits)
        and trace, each gate's live allocated memory (cyclic garbage
        collected before each reading) back to its value before it and
        the process's after every cycle back to its value before the
        first gate, telemetry's cost a step (syncs and
        params), and the crash drill: a journal left in CANARY by a dead
        owner, a second incarnation promotes the same step.
    (b) `python -m deeplearning4j_tpu_torch.cli pipeline --spawn-fleet`
        with two `cli serve --device cuda` replicas and a state dir:
        exit 0, the JAX CLI's announce keys, step 12 promoted (the
        journals of the controller and the fleet; each ready replica's
        /stats), then the replicas it handed off are stopped and no
        process of their groups is left."""
    from deeplearning4j_tpu_torch import cli as port_cli
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                     list_steps)
    from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
    from deeplearning4j_tpu_torch.checkpoint.restore import restore_network
    from deeplearning4j_tpu_torch.deploy import (CANARY,
                                                 DeploymentController)
    from deeplearning4j_tpu_torch.eval import holdout
    from deeplearning4j_tpu_torch.scaleout.checkpoint import \
        DefaultModelSaver
    from deeplearning4j_tpu_torch.serving import Fleet, serve_network
    from deeplearning4j_tpu_torch.telemetry import trace as ttrace
    from deeplearning4j_tpu_torch.utils import procs

    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    PIPE_DIR.mkdir(parents=True)
    out, ok = {"card": nvidia_smi()}, True
    paths, parts = pipeline_data(seed)
    xh, yh = parts["held"]
    root = PIPE_DIR / "ck"
    want = {"path": os.path.abspath(root), "step": None}
    reg = telemetry.get_registry()
    dev = torch.device(device).type

    out["telemetry_cost"] = telemetry_cost(device, xh, yh)
    ok = ok and out["telemetry_cost"]["ok"]

    # ------------------------------------------------ (a) the trainer
    conf_path = PIPE_DIR / "attention.json"
    conf_path.write_text(attention_conf("bfloat16").to_json())
    batch = ML_TRAIN["attention"][0]
    n_steps = PIPE_EPOCHS * PIPE_ROWS // batch
    trace_path = PIPE_DIR / "train_trace.json"
    scraped = []
    close = port_cli._Telemetry.close

    def scrape_then_close(tele):
        # the trainer's own endpoint, read just before it shuts down
        if tele.metrics is not None:
            scraped.append(http_get(tele.metrics.url + "/metrics")[1]
                           .decode())
        return close(tele)

    counted = ("dl4j_train_steps", "dl4j_ckpt_saves")
    before = {n: reg.counter(n).value for n in counted}
    writes = reg.histogram("dl4j_ckpt_write_seconds")
    writes0 = (writes.count, writes.sum)
    torch.cuda.synchronize()
    reset_flash_counts()
    port_cli._Telemetry.close = scrape_then_close
    try:
        rc, text, train_s = run_cli(
            ["train", "-i", paths["train"], "-m", conf_path, "--device", dev,
             "--batch-size", batch, "--epochs", PIPE_EPOCHS, "-o",
             PIPE_DIR / "final.ckpt", "--checkpoint-dir", root,
             "--checkpoint-every", PIPE_EVERY, "--metrics-port", 0,
             "--trace", trace_path])
    finally:
        port_cli._Telemetry.close = close
        ttrace.stop_tracing()
    lines = [json.loads(s) for s in text.strip().splitlines()] \
        if rc == 0 else []
    committed = list_steps(str(root))
    series = metric_samples(scraped[0], "dl4j_") if scraped else {}
    with open(trace_path) as f:
        span_names = {e["name"] for e in json.load(f)["traceEvents"]}
    trainer = {
        "rc": rc, "wall_s": train_s, "steps": n_steps,
        "announce": lines[0] if lines else None,
        "summary": lines[-1] if lines else None,
        "committed": committed,
        "metrics_steps": series.get("dl4j_train_steps_total", 0.0)
        - before["dl4j_train_steps"],
        "metrics_commits": series.get("dl4j_ckpt_saves_total", 0.0)
        - before["dl4j_ckpt_saves"],
        "ckpt_write_s": {"count": writes.count - writes0[0],
                         "mean": (writes.sum - writes0[1])
                         / max(1, writes.count - writes0[0])},
        "trace_spans": sorted(span_names & {"train_step", "ckpt_snapshot",
                                            "ckpt_write"})}
    train_ok = (rc == 0 and "metrics" in trainer["announce"]
                and trainer["summary"]["trace"] == str(trace_path)
                and committed == list(range(PIPE_EVERY, n_steps + 1,
                                            PIPE_EVERY))
                and trainer["metrics_steps"] == n_steps
                and trainer["metrics_commits"] == len(committed)
                and len(trainer["trace_spans"]) == 3)
    out["trainer"] = trainer
    ok = ok and train_ok
    good = committed[-1]
    want["step"] = good
    with open(root / ckfmt.step_dir_name(good) / ckfmt.MARKER) as f:
        committed_at = json.load(f)["committed_at"]

    # the two poisons, committed after the last good step
    poisoned, _ = restore_network(str(root), good, device=device)
    with torch.no_grad():
        poisoned.param_table["1"]["W"].neg_()
    mlp = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    mlp.fit(ListDataSetIterator(DataSet(*parts["train"]), batch))
    with ShardedModelSaver(str(root), keep=10) as saver:
        saver.save(poisoned, step=good + 1)
        saver.save(mlp, step=good + 2)
    del poisoned, mlp

    # ------------------------------------------ (a) fleet + controller
    boot = PIPE_DIR / "boot"
    with ShardedModelSaver(str(boot)) as saver:
        saver.save(MultiLayerNetwork(attention_conf("bfloat16"),
                                     device=device), step=0)
    handles = [serve_network(MultiLayerNetwork(attention_conf("bfloat16"),
                                               device=device),
                             max_delay_ms=2.0, warmup_shape=(784,),
                             checkpoint={"path": str(boot), "step": 0})
               for _ in range(2)]
    # a replica's engine starts on its network's own tensors, and its
    # first reload gives it copies (the network lives on in the forward's
    # closure): reload each once, so every later reload swaps like for
    # like and only the controller's gates can move allocated memory
    for h in handles:
        h.load_checkpoint(str(boot), step=0)
    fleet = Fleet(initial_checkpoint=str(boot), **FLEET_MONITOR)
    gates, cycles = [], []
    evaluate = holdout.evaluate_checkpoint

    def measured(*args, **kwargs):
        m0 = live_allocated(device)
        try:
            return evaluate(*args, **kwargs)
        finally:
            gates.append({"before": m0, "after": live_allocated(device)})

    ctrl = drill = None
    a = {}
    try:
        for h in handles:
            fleet.attach(h.url)
        fleet.wait_ready(2, timeout=120)
        ctrl = DeploymentController(
            str(root), fleet=fleet, eval_data=str(paths["held"]),
            eval_threshold=PIPE_THRESHOLD, poll_interval=0.01,
            probe={"inputs": xh[:4].tolist()},
            state_dir=str(PIPE_DIR / "state"), name="smoke",
            status_port=0, device=device)
        holdout.evaluate_checkpoint = measured
        garbage0, t0 = torch.cuda.memory_allocated(device), time.perf_counter()
        mem0 = live_allocated(device)
        a["collect_s"] = time.perf_counter() - t0
        serving_s = None
        for _ in range(4):
            t0 = time.perf_counter()
            res = ctrl.run_once()
            cycles.append({**res, "seconds": time.perf_counter() - t0,
                           "memory_allocated": live_allocated(device)})
            if res.get("promoted"):
                if all(json.loads(http_get(h.url + "/readyz")[1])
                       .get("checkpoint") == want for h in handles):
                    serving_s = time.time() - committed_at
        holdout.evaluate_checkpoint = evaluate
        torch.cuda.synchronize()
        launches = flash_counts()  # before any reference forward
        outcome = [{k: c.get(k) for k in ("action", "step", "promoted",
                                          "rolled_back")} for c in cycles]
        a["cycles"] = cycles
        a["commit_to_serving_s"] = serving_s
        a["gates"] = gates
        a["memory_allocated_before_first_gate"] = mem0
        a["collected_before_first_gate"] = garbage0 - mem0
        cycles_ok = outcome == [
            {"action": "promote", "step": good + 2, "promoted": False,
             "rolled_back": True},
            {"action": "eval", "step": good + 1, "promoted": False,
             "rolled_back": None},
            {"action": "promote", "step": good, "promoted": True,
             "rolled_back": None},
            {"action": "idle", "step": None, "promoted": None,
             "rolled_back": None}]
        reasons = {k: v.split(":")[0] for k, v in ctrl.quarantined.items()}
        markers = [os.path.exists(root / ckfmt.step_dir_name(s)
                                  / "QUARANTINED")
                   for s in (good + 1, good + 2)]
        a.update({"champion": ctrl.champion, "quarantined": reasons,
                  "markers": markers})
        verdict_ok = (ctrl.champion["step"] == good and all(markers)
                      and reasons == {str(good + 1): "eval_gate",
                                      str(good + 2): "canary"})
        memory_ok = (len(gates) == 3
                     and all(g["after"] == g["before"] for g in gates)
                     and all(c["memory_allocated"] == mem0
                             for c in cycles))
        status = metric_samples(
            http_get(ctrl.status_address + "/metrics")[1].decode(),
            "dl4j_pipeline_", 'pipeline="smoke"')
        a["status_metrics"] = status
        a["healthz"] = json.loads(http_get(ctrl.status_address
                                           + "/healthz")[1])
        counters_ok = (status.get("dl4j_pipeline_promotions_total") == 1
                       and status.get("dl4j_pipeline_rollbacks_total") == 1
                       and status.get("dl4j_pipeline_quarantines_total")
                       == 2 and a["healthz"]["ok"])
        stats_ok = all(h.stats()["checkpoint"] == want for h in handles)

        # the replicas against step 12 restored on the card
        champ, _ = restore_network(str(root), good, device=device)
        rows = xh[:64]
        ref = champ.output(rows).float().cpu()
        errs = [max_err(torch.tensor(http_post(
                    h.url + "/predict", {"inputs": rows.tolist()})
                    ["outputs"]), ref) for h in handles]
        a["predict_max_abs_err"] = errs
        predict_ok = max(errs) <= TOL[torch.bfloat16]

        # the card's gate against a float32 gate on the CPU
        cpu = MultiLayerNetwork(attention_conf("float32"), device="cpu")
        cpu.param_table = champ.param_table
        ev = Evaluation()
        ev.eval(yh, cpu.output(xh).numpy())
        cpu_gate = {"f1": ev.f1(), "accuracy": ev.accuracy()}
        diffs = gate_rows(champ.output(xh), output_logits(cpu, xh))
        a["gate"] = {"card": {k: ctrl.champion["metrics"][k]
                              for k in ("f1", "accuracy", "n",
                                        "eval_seconds")},
                     "cpu_float32": cpu_gate, "differing_rows": diffs}
        gate_ok = (ctrl.champion["metrics"]["f1"] >= PIPE_THRESHOLD
                   and near_ties(diffs, TOL[torch.bfloat16],
                                 rounded_in=torch.bfloat16)
                   and (bool(diffs) or ctrl.champion["metrics"]["f1"]
                        == cpu_gate["f1"]))
        del champ, cpu

        # the crash drill: killed in CANARY, the next incarnation from
        # the same state dir re-drives the promotion to the same verdict
        drill_state = str(PIPE_DIR / "drill_state")
        drill = DeploymentController(str(root), fleet=fleet,
                                     state_dir=drill_state, name="drill",
                                     device=device)
        journal = drill.journal.read()
        journal.update({"owner": {"pid": 2 ** 30, "start_time": 1.0},
                        "phase": CANARY,
                        "candidate": {"path": want["path"], "step": good,
                                      "metrics": None}})
        drill.journal.write(journal)
        drill.close(release=False)
        drill = DeploymentController(str(root), fleet=fleet,
                                     state_dir=drill_state, name="drill",
                                     device=device)
        adopted = drill.phase
        res = drill.run_once()
        a["crash_drill"] = {"adopted_phase": adopted, "result": res,
                            "incarnation": drill.incarnation}
        drill_ok = (adopted == CANARY and drill.incarnation == 1
                    and res == {"action": "promote", "promoted": True,
                                "step": good}
                    and drill.champion["step"] == ctrl.champion["step"])
        a["ok"] = {"cycles": cycles_ok, "verdicts": verdict_ok,
                   "memory": memory_ok, "counters": counters_ok,
                   "stats": stats_ok, "predict": predict_ok,
                   "gate": gate_ok, "crash_drill": drill_ok}
        ok = ok and all(a["ok"].values())
    finally:
        holdout.evaluate_checkpoint = evaluate
        for c in (ctrl, drill):
            if c is not None:
                c.close()
        fleet.close()
        for h in handles:
            h.close()
    out["in_process"] = a
    out["launches"] = launches
    ok = (ok and launches["flash_bwd_dq"] == n_steps
          and launches["flash_bwd_dkv"] == n_steps
          and launches["flash_fwd"] > n_steps)

    # ------------------------------------- (b) cli pipeline, spawned
    init = PIPE_DIR / "init.ckpt"
    DefaultModelSaver(str(init)).save(
        MultiLayerNetwork(attention_conf("bfloat16"), device=device))
    state = PIPE_DIR / "sub_state"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "pipeline",
         "--checkpoint-dir", str(root), "--spawn-fleet", "-m", str(init),
         "--replicas", "2", "--device", dev, "--eval-data",
         str(paths["held"]), "--eval-threshold", str(PIPE_THRESHOLD),
         "--state-dir", str(state), "--status-port", "0", "--cycles", "3",
         "--poll-interval", "1", "--name", "smoke-spawned",
         # `cli serve` warms at the first layer's n_in (28 here, before
         # the 28 x 28 reshape), as the JAX CLI does: warm by the probe
         "--serve-arg=--no-warmup"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(Path(__file__).resolve().parent))
    b = {"rc": sub.returncode, "wall_s": time.perf_counter() - t0,
         "stderr_tail": sub.stderr[-600:]}
    announce = json.loads(sub.stdout.splitlines()[0]) \
        if sub.returncode == 0 else {}
    b["announce"] = announce
    controller = json.load(open(state / "controller.journal")) \
        if (state / "controller.journal").exists() else {}
    fleet_journal = json.load(open(state / "fleet" / "fleet.journal")) \
        if (state / "fleet" / "fleet.journal").exists() else {}
    replicas = list((fleet_journal.get("replicas") or {}).values())
    served = []
    for r in replicas:
        try:
            served.append(json.loads(http_get(r["url"] + "/stats")[1])
                          .get("checkpoint"))
        except OSError:
            served.append(None)
    b.update({"champion": controller.get("champion"),
              "fleet_current_step": fleet_journal.get("current_step"),
              "replica_states": [r.get("state") for r in replicas],
              "served": served})
    # the pipeline handed its warm replicas off to a successor (its
    # state dir): stop them as one would, then no member may be left
    for r in replicas:
        if r.get("pid"):
            procs.stop_process_group(
                procs.AdoptedProc(r["pid"], r.get("start_time")))
    left = {r["pid"]: live_group_members(r["pid"])
            for r in replicas if r.get("pid")}
    b["left_in_groups"] = left
    b_ok = (sub.returncode == 0 and set(announce) == PIPE_ANNOUNCE_KEYS
            and (controller.get("champion") or {}).get("step") == good
            and fleet_journal.get("current_step") == good
            and len(left) == 2 and not any(left.values())
            and any(s == want for s in served)
            and all(s == want for s, r in zip(served, replicas)
                    if r.get("state") == "ready"))
    b["ok"] = b_ok
    out["spawned"] = b
    ok = ok and b_ok
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    out["ok"] = ok
    return out


def lstm_conf(d, compute_dtype):
    return NeuralNetConfiguration(layer="lstm", n_in=d, n_out=d,
                                  activation_function="tanh",
                                  loss_function="mcxent",
                                  compute_dtype=compute_dtype)


def lstm_bytes(seed, b, t, d):
    """(x, y): one-hot bytes (mod d) of LSTM_PHRASE read cyclically from
    a random offset per row, y the next byte (cyclic_tokens' manner)."""
    phrase = np.frombuffer(LSTM_PHRASE, np.uint8).astype(np.int64) % d
    off = np.random.RandomState(seed).randint(0, len(phrase), (b, 1))
    idx = phrase[(off + np.arange(t + 1)[None, :]) % len(phrase)]
    eye = np.eye(d, dtype=np.float32)
    return (torch.from_numpy(eye[idx[:, :-1]]),
            torch.from_numpy(eye[idx[:, 1:]]))


def lstm_sgd_step(layer, params, x, y, lr):
    loss = layer.loss(params, x, y)
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        torch._foreach_add_(list(params.values()), list(grads), alpha=-lr)
    return loss.detach()


def lstm_parity(device, seed):
    """Card vs CPU in float32 at LSTM_PARITY: activate, loss, the
    gradients of R, Wd and bd, 3 SGD steps, and run_stream in chunks with
    a carry."""
    from deeplearning4j_tpu_torch.nn.layers import make_layer

    d, t, b = LSTM_PARITY["d"], LSTM_PARITY["t"], LSTM_PARITY["b"]
    layers_ = {dev: make_layer(lstm_conf(d, "float32"), device=dev)
               for dev in (device, "cpu")}
    layers_["cpu"].init_params(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in layers_[device].param_dict().items():
            p.copy_(layers_["cpu"].param_dict()[name])
    x, y = lstm_bytes(seed, b, t, d)
    x = x + 0.1 * torch.randn(x.shape, generator=torch.Generator()
                              .manual_seed(seed))
    res = {}
    for dev, layer in layers_.items():
        params = layer.param_dict()
        xd, yd = x.to(dev), y.to(dev)
        out = layer.activate(params, xd).detach().cpu()
        loss = layer.loss(params, xd, yd)
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, list(params.values()))]
        chunks = []
        carry = None
        for lo in range(0, t, 5):
            o, carry = layer.run_stream(params, xd[:, lo:lo + 5], carry)
            chunks.append(o.cpu())
        for _ in range(3):
            lstm_sgd_step(layer, params, xd, yd, 0.1)
        res[dev] = {"out": out, "loss": loss.detach().cpu(),
                    "grads": grads, "stream": torch.cat(chunks, 1),
                    "params": [p.detach().cpu() for p in params.values()]}
    card, cpu = res[device], res["cpu"]
    errs = {"activate": max_err(card["out"], cpu["out"]),
            "loss_rel": max_err(card["loss"], cpu["loss"])
            / float(cpu["loss"].abs()),
            "grads": max(max_err(g, w) for g, w in zip(card["grads"],
                                                      cpu["grads"])),
            "run_stream": max_err(card["stream"], cpu["stream"]),
            "stream_vs_activate": max_err(card["stream"], card["out"]),
            "params_3_steps": max(max_err(g, w) for g, w in
                                  zip(card["params"], cpu["params"]))}
    tol = LSTM_PARITY_TOL
    ok = (max(errs["activate"], errs["loss_rel"], errs["run_stream"],
              errs["stream_vs_activate"]) <= tol["outputs"]
          and max(errs["grads"], errs["params_3_steps"]) <= tol["params"])
    return {"shape": LSTM_PARITY, "max_abs_err": errs, "tolerance": tol,
            "ok": ok}


def lstm_full(device, seed):
    """Bytes at full width (LSTM_FULL), bf16 products, SGD: the loss
    halves; chunked run_stream equals activate; a 5-beam, 20-step beam
    search returns sorted beams. ms a step by CUDA events, tokens/s,
    kernels a step and the busy share, ms a beam tick."""
    from deeplearning4j_tpu_torch.nn.layers import make_layer

    cfg = LSTM_FULL
    d, t, b = cfg["d"], cfg["t"], cfg["b"]
    layer = make_layer(lstm_conf(d, "bfloat16"), device=device)
    layer.init_params(torch.Generator().manual_seed(seed))
    params = layer.param_dict()
    x, y = (a.to(device) for a in lstm_bytes(seed + 1, b, t, d))
    losses = []
    step_ms = []
    for _ in range(cfg["steps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(lstm_sgd_step(layer, params, x, y, cfg["lr"]))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    losses = [float(v) / t for v in losses]  # per-step cross entropy
    steady = sorted(step_ms[2:])
    p50 = steady[len(steady) // 2]
    profile = device_profile(
        lambda: lstm_sgd_step(layer, params, x, y, cfg["lr"]), 2, ML_GROUPS)

    full = layer.activate(params, x).detach()
    chunks, carry = [], None
    for lo in range(0, t, 32):
        o, carry = layer.run_stream(params, x[:, lo:lo + 32], carry)
        chunks.append(o)
    stream_err = max_err(torch.cat(chunks, 1), full)

    ws = torch.eye(d, device=device)
    start_byte = LSTM_PHRASE[0]
    beams, beam_ms = timed_ms(lambda: layer.predict(
        params, ws[start_byte], ws, beam_size=cfg["beam"],
        n_steps=cfg["beam_steps"]))
    ticks = 1 + cfg["beam"] * (cfg["beam_steps"] - 1)
    logps = [lp for _, lp in beams]
    beams_ok = (len(beams) == cfg["beam"] and logps == sorted(logps,
                                                              reverse=True)
                and all(0 <= tok < d for s, _ in beams for tok in s))
    finite = all(np.isfinite(losses))
    return {"config": cfg, "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses[::5] + [losses[-1]],
            "ms_per_step_p50": p50, "ms_per_step": step_ms,
            "tokens_per_s": b * t / (p50 / 1e3),
            "step_profile": profile,
            "run_stream_vs_activate_max_abs_err": stream_err,
            "beams": [(s, lp) for s, lp in beams],
            "beam_ms_per_tick": beam_ms / ticks,
            "ok": (finite and losses[-1] < 0.5 * losses[0]
                   and stream_err <= LSTM_PARITY_TOL["outputs"]
                   and beams_ok)}


def phase_lstm(device, seed):
    """The LSTM (models/lstm.py): card vs CPU in float32, then the byte
    model at full width."""
    parity = lstm_parity(device, seed)
    full = lstm_full(device, seed)
    return {"card": nvidia_smi(), "parity": parity, "full": full,
            "ok": parity["ok"] and full["ok"]}


# ------------------------------------------------------ phase 20: nlp
NLP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_nlp"
NLP_TOKENS, NLP_VOCAB, NLP_DIM, NLP_WINDOW = 200_000, 2000, 128, 5
NLP_B, NLP_CB = 4096, 32
NLP_WINDOWS = 3           # timed train_pairs windows (bench.py's REPEATS)
NLP_TOL = 1e-4            # card vs CPU, of the largest |entry| of a table
GLOVE_BATCH, GLOVE_EPOCHS = 8192, 16
PV_DOCS, PV_LEN, PV_TOPICS, PV_TOPIC_WORDS = 100_000, 20, 20, 500
PV_PROBES, PV_RETRIEVAL = 200, 0.9
VITERBI_SEQS, VITERBI_STATES = 64, 4
#: device-time groups of a word-vector profile (index_add_ runs as
#: indexFunc{Small,Large}Index, indexing gathers as index_elementwise /
#: vectorized_gather, the _foreach AdaGrad as multi_tensor_apply)
NLP_GROUPS = {"scatter": ("indexFuncSmallIndex", "indexFuncLargeIndex"),
              "gather": ("vectorized_gather", "index_elementwise",
                         "index_select"),
              "bmm": ("gemm", "gemv", "nvjet", "Kernel2", "dot_kernel"),
              "foreach": "multi_tensor_apply",
              "random": ("philox", "distribution")}


def zipf_sentences(n_tokens, vocab_size, seed=0, sent_len=40):
    """bench.py's `_zipf_sentences` (BASELINE configs 3 and 5)."""
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(vocab_size)]
    zipf = 1.0 / np.arange(1, vocab_size + 1)
    probs = zipf / zipf.sum()
    tokens = rng.choice(vocab_size, size=n_tokens, p=probs)
    return [" ".join(vocab[t] for t in tokens[i:i + sent_len])
            for i in range(0, n_tokens, sent_len)]


def topic_documents(seed, n_docs):
    """Config 3c's corpus: n_docs documents of PV_LEN tokens, each from
    one of PV_TOPICS topics (its label), drawn zipfian from the topic's
    own PV_TOPIC_WORDS words (a 10k vocab)."""
    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, PV_TOPIC_WORDS + 1)
    topics = rng.randint(0, PV_TOPICS, size=n_docs)
    ranks = rng.choice(PV_TOPIC_WORDS, size=(n_docs, PV_LEN),
                       p=zipf / zipf.sum())
    words = topics[:, None] * PV_TOPIC_WORDS + ranks
    return [(f"t{t}", " ".join(f"v{w}" for w in row))
            for t, row in zip(topics, words)]


def table_errs(cpu, card) -> dict:
    """max |card - cpu| / max |cpu| per table ({name: table} each)."""
    out = {}
    for name, a in cpu.items():
        a = torch.as_tensor(a).double()
        out[name] = float((card[name].detach().cpu().double() - a).abs().max()
                          / a.abs().max().clamp_min(1e-30))
    return out


def nlp_card_vs_cpu(device, sentences, pairs, seed) -> dict:
    """(a) One train_pairs chunk (NLP_CB x NLP_B pairs) with negative
    sampling and with HS, and one GloVe epoch, on the card and on the
    CPU from the same start with the same negatives and order."""
    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec

    n = NLP_B * NLP_CB
    c, x = pairs[0][:n], pairs[1][:n]
    out = {}
    for mode, negative in (("negative", 5), ("hs", 0)):
        kw = dict(layer_size=NLP_DIM, window=NLP_WINDOW,
                  min_word_frequency=1, negative=negative, seed=seed,
                  batch_pairs=NLP_B, chunk_batches=NLP_CB)
        cpu = Word2Vec(sentences, device="cpu", **kw)
        card = Word2Vec(sentences, device=device, **kw)
        cpu.build_vocab()
        card.build_vocab()
        negs = None
        if negative:
            uni = cpu._unigram_table()
            negs = uni[np.random.RandomState(seed + 7).randint(
                0, uni.size, (n, negative))]
        cpu.train_pairs(c, x, alpha=0.025, negatives=negs)
        card.train_pairs(c, x, alpha=0.025, negatives=negs)
        names = ("syn0", "syn1neg" if negative else "syn1")
        errs = table_errs({n: getattr(cpu, n) for n in names},
                          {n: getattr(card, n) for n in names})
        out[mode] = {"rel_err": errs,
                     "ok": all(e <= NLP_TOL for e in errs.values())}
    kw = dict(layer_size=NLP_DIM, window=NLP_WINDOW, min_word_frequency=1,
              batch_size=GLOVE_BATCH, seed=seed)
    cpu = Glove(sentences, device="cpu", **kw).prepare()
    card = Glove(sentences, device=device, **kw).prepare()
    perm = np.random.RandomState(seed + 8).permutation(cpu._triples[0].size)
    lc = cpu.train_epochs(1, perms=[perm])
    lg = card.train_epochs(1, perms=[perm])
    errs = table_errs(cpu._params, card._params)
    errs.update({f"accum_{k}": v for k, v in
                 table_errs(cpu._accum, card._accum).items()})
    out["glove"] = {"rel_err": errs, "loss": [lc, lg],
                    "ok": all(e <= NLP_TOL for e in errs.values())
                    and abs(lc - lg) <= NLP_TOL * abs(lc)}
    out["tolerance"] = NLP_TOL
    out["ok"] = all(out[k]["ok"] for k in ("negative", "hs", "glove"))
    return out


def nlp_word2vec(device, sentences, seed, negative, pairs=None) -> tuple:
    """(b) BASELINE config 3 (bench.py:290-329): pairs mined once and
    uploaded once, then NLP_WINDOWS timed train_pairs windows over all of
    them. Returns (record, model, host pairs)."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(sentences, layer_size=NLP_DIM, window=NLP_WINDOW,
                   min_word_frequency=1, negative=negative, iterations=1,
                   seed=seed, batch_pairs=NLP_B, chunk_batches=NLP_CB,
                   device=device)
    w2v.build_vocab()  # before the clock: mine_s times MINING only
    t0 = time.perf_counter()
    mined = w2v.mine_pairs(np.random.RandomState(1))
    mine_s = time.perf_counter() - t0
    if pairs is None:
        pairs = mined
    B, CB = NLP_B, NLP_CB
    n = pairs[0].size // (B * CB) * (B * CB)
    centers = torch.from_numpy(pairs[0][:n]).to(device)  # int32, once
    contexts = torch.from_numpy(pairs[1][:n]).to(device)
    chunk = (centers[:B * CB], contexts[:B * CB])
    w2v.train_pairs(*chunk)
    first_loss = float(w2v.last_loss)
    syncs = count_syncs(lambda: w2v.train_pairs(*chunk))
    secs = []
    for _ in range(NLP_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w2v.train_pairs(centers, contexts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    prof = device_profile(lambda: w2v.train_pairs(*chunk), iters=2,
                          groups=NLP_GROUPS)
    # the first chunk's last batch again, after the windows trained on
    # every pair (the pairs come in mining order, so batches further on
    # hold other window offsets and are not comparable)
    last_loss = float(w2v.last_loss)
    w2v.refresh_vectors()
    win = sorted(secs)[len(secs) // 2]
    finite = bool(np.isfinite(w2v.syn0).all() and torch.isfinite(
        w2v.syn1neg if negative else w2v.syn1).all())
    rec = {"negative": negative, "pairs_mined": int(mined[0].size),
           "pairs_per_window": n, "mine_s": mine_s, "window_s": secs,
           "pairs_per_s": n / win, "ms_per_batch": win * 1e3 / (n // B),
           "kernels_per_batch": prof.get("kernels_per_call", 0) / CB,
           "device_ms_per_batch": prof.get("device_ms_per_call", 0) / CB,
           "wall_ms_per_batch_profiled":
               prof.get("wall_ms_per_call", 0) / CB,
           "busy_share": prof.get("device_busy_share"),
           "profile": prof, "syncs_in_chunk": syncs,
           "loss_first_chunk": first_loss,
           "loss_first_chunk_after": last_loss,
           "finite": finite}
    rec["ok"] = (syncs == 0 and finite and last_loss < first_loss
                 and "device_ms_per_call" in prof)
    return rec, w2v, mined


def nlp_glove(device, sentences, seed) -> dict:
    """(c) BASELINE config 5 (bench.py:332-361): prepare once, then two
    timed windows of GLOVE_EPOCHS epochs."""
    from deeplearning4j_tpu_torch.nlp import Glove

    glove = Glove(sentences, layer_size=NLP_DIM, window=NLP_WINDOW,
                  min_word_frequency=1, batch_size=GLOVE_BATCH, seed=seed,
                  device=device)
    t0 = time.perf_counter()
    glove.prepare()
    prep_s = time.perf_counter() - t0
    first = glove.train_epochs(1)
    n = glove._triples[0].size
    n_pad = (n + GLOVE_BATCH - 1) // GLOVE_BATCH * GLOVE_BATCH
    steps = n_pad // GLOVE_BATCH
    syncs = count_syncs(lambda: glove.run_epochs(1))
    secs, loss = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = glove.train_epochs(GLOVE_EPOCHS)
        secs.append(time.perf_counter() - t0)
    prof = device_profile(lambda: glove.run_epochs(1), iters=2,
                          groups=NLP_GROUPS)
    win = min(secs)
    finite = bool(np.isfinite(glove.syn0).all())
    rec = {"triples": int(n), "steps_per_epoch": steps, "prepare_s": prep_s,
           "window_s": secs, "epochs_per_window": GLOVE_EPOCHS,
           "triples_per_s": GLOVE_EPOCHS * n_pad / win,
           "ms_per_step": win * 1e3 / (GLOVE_EPOCHS * steps),
           "kernels_per_step": prof.get("kernels_per_call", 0) / steps,
           "device_ms_per_step": prof.get("device_ms_per_call", 0) / steps,
           "busy_share": prof.get("device_busy_share"), "profile": prof,
           "syncs_in_epoch": syncs, "loss_first_epoch": first,
           "loss_final": loss, "finite": finite}
    rec["ok"] = (syncs == 0 and finite and loss < first
                 and "device_ms_per_call" in prof)
    return rec


def nlp_paragraph_vectors(device, seed, shared=None) -> dict:
    """(d) BASELINE config 3c (BASELINE.md:86): ParagraphVectors end to end
    through fit on PV_DOCS topic documents; word -> own-label retrieval
    on PV_PROBES probe words (PV_PROBES / PV_TOPICS a topic, drawn from
    the seed among the topic's words). Hands the trained word vectors,
    their topic ids and counts to phase 22 through `shared`."""
    from deeplearning4j_tpu_torch.nlp import ParagraphVectors

    docs = topic_documents(seed, PV_DOCS)
    pv = ParagraphVectors(docs, layer_size=NLP_DIM, negative=5,
                          iterations=3, seed=seed, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pv.fit()
    fit_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed + 9)
    hits, probes = 0, 0
    for t in range(PV_TOPICS):
        for r in rng.choice(PV_TOPIC_WORDS, PV_PROBES // PV_TOPICS,
                            replace=False):
            word = f"v{t * PV_TOPIC_WORDS + r}"
            if not pv.has_word(word):
                continue
            probes += 1
            hits += pv.nearest_labels(word, n=1)[0][0] == f"t{t}"
    retrieval = hits / max(probes, 1)
    if shared is not None:
        words = pv.vocab.words()
        syn0 = pv.syn0
        shared["config3c"] = {
            "words": words,
            "vectors": np.asarray(syn0.detach().cpu().numpy()
                                  if isinstance(syn0, torch.Tensor) else syn0,
                                  np.float32),
            "topics": np.array([
                int(w[len("__label__t"):]) if w.startswith("__label__")
                else int(w[1:]) // PV_TOPIC_WORDS for w in words]),
            "counts": np.array([pv.vocab.word_frequency(w) for w in words])}
    return {"documents": PV_DOCS, "tokens": PV_DOCS * PV_LEN,
            "vocab": pv.vocab.num_words(), "pairs": pv.pairs_trained,
            "fit_s": fit_s, "pairs_per_s": pv.pairs_trained / fit_s,
            "probes": probes, "retrieval": retrieval,
            "ok": probes == PV_PROBES and retrieval >= PV_RETRIEVAL}


def chain_tables(states, observed, meta=0.9, p=0.99):
    """Viterbi's 2-parameter chain as float64 tables for viterbi_path."""
    init = np.full(states, -math.log(states))
    trans = np.full((states, states), math.log((1 - meta) / (states - 1)))
    np.fill_diagonal(trans, math.log(meta))
    emits = np.where(observed[:, None] == np.arange(states)[None, :],
                     math.log(p), math.log((1 - p) / (states - 1)))
    return init, trans, emits


def path_score(init, trans, emits, path) -> float:
    return float(init[path[0]] + emits[np.arange(len(path)), path].sum()
                 + trans[path[:-1], path[1:]].sum())


def nlp_rest(device, seed, w2v, sentences) -> dict:
    """(e) The serializer, Viterbi and the DataSet bridge on the card."""
    from deeplearning4j_tpu_torch.nlp import (LabelAwareSentenceIterator,
                                              Word2VecDataSetIterator,
                                              load_word_vectors,
                                              save_word_vectors)
    from deeplearning4j_tpu_torch.utils.viterbi import Viterbi, viterbi_path

    out = {}
    shutil.rmtree(NLP_DIR, ignore_errors=True)
    NLP_DIR.mkdir(parents=True)
    try:
        ser = {}
        for binary in (True, False):
            path = NLP_DIR / ("vectors.bin" if binary else "vectors.txt")
            save_word_vectors(w2v, str(path), binary=binary)
            loaded = load_word_vectors(str(path), binary=binary)
            again = NLP_DIR / ("again.bin" if binary else "again.txt")
            save_word_vectors(loaded, str(again), binary=binary)
            rec = {"bytes": path.stat().st_size,
                   "vocab_equal": loaded.vocab.words() == w2v.vocab.words(),
                   "resaved_bytes_equal":
                       again.read_bytes() == path.read_bytes(),
                   "bit_equal": bool(np.array_equal(
                       loaded.syn0.view(np.uint32),
                       w2v.syn0.view(np.uint32))),
                   "max_rel_err": float(np.abs(loaded.syn0 - w2v.syn0).max()
                                        / np.abs(w2v.syn0).max())}
            # the text format keeps 6 significant digits (the JAX
            # package's "%.6g"): bit-equal through binary, and a text
            # file loads and saves again to the same bytes
            rec["ok"] = (rec["vocab_equal"] and rec["resaved_bytes_equal"]
                         and (rec["bit_equal"] if binary
                              else rec["max_rel_err"] <= 1e-5))
            ser["binary" if binary else "text"] = rec
        out["serializer"] = ser
    finally:
        shutil.rmtree(NLP_DIR, ignore_errors=True)
    rng = np.random.RandomState(seed + 10)
    card_v = Viterbi(np.arange(VITERBI_STATES), device=device)
    cpu_v = Viterbi(np.arange(VITERBI_STATES), device="cpu")
    decode_equal = general_equal = numpy_equal = 0
    worst_gap = 0.0
    for _ in range(VITERBI_SEQS):
        obs = rng.randint(0, VITERBI_STATES, size=1 + rng.randint(0, 64))
        logp, path = card_v.decode(obs, binary_label_matrix=False)
        decode_equal += bool(np.array_equal(
            path, cpu_v.decode(obs, binary_label_matrix=False)[1]))
        tables = chain_tables(VITERBI_STATES, obs)
        best, npath = viterbi_path(*tables)
        numpy_equal += bool(np.array_equal(path, npath))
        worst_gap = max(worst_gap, abs(path_score(*tables, path) - best)
                        / abs(best))
        li = np.log(rng.dirichlet(np.ones(VITERBI_STATES)))
        lt = np.log(rng.dirichlet(np.ones(VITERBI_STATES),
                                  size=VITERBI_STATES))
        le = np.log(rng.dirichlet(np.ones(VITERBI_STATES), size=len(obs)))
        general_equal += bool(np.array_equal(
            viterbi_path(li, lt, le, backend="torch", device=device)[1],
            viterbi_path(li, lt, le)[1]))
    # the 2-parameter chain has exact ties between paths; float32 and
    # float64 may break them apart differently, so decode is held to the
    # CPU's float32 decode path for path and to the numpy backend by
    # score (an optimal path), and viterbi_path on tie-free random HMMs
    # to the numpy backend path for path
    out["viterbi"] = {"sequences": VITERBI_SEQS,
                      "decode_equal_cpu": decode_equal,
                      "decode_equal_numpy": numpy_equal,
                      "decode_worst_score_gap": worst_gap,
                      "viterbi_path_equal_numpy": general_equal,
                      "ok": decode_equal == general_equal == VITERBI_SEQS
                      and worst_gap <= 1e-5}
    labeled = [(f"l{i % 2}", s) for i, s in enumerate(sentences[:16])]
    it = Word2VecDataSetIterator(w2v, LabelAwareSentenceIterator(labeled),
                                 labels=["l0", "l1"], batch=64)
    ds = it.next()
    shape_ok = (ds.features.shape == (64, NLP_DIM * NLP_WINDOW)
                and ds.labels.shape == (64, 2)
                and bool((ds.labels.sum(axis=1) == 1).all())
                and bool(np.isfinite(ds.features).all()))
    out["dataset_iterator"] = {"features": list(ds.features.shape),
                               "labels": list(ds.labels.shape),
                               "ok": shape_ok}
    out["ok"] = (all(r["ok"] for r in ser.values()) and out["viterbi"]["ok"]
                 and shape_ok)
    return out


def phase_nlp(device, seed, shared=None):
    """Phase 20; see the module docstring. `shared` receives config 3c's
    word vectors for phase 22."""
    before = {**flash_counts(), "paged_decode": paged.launches}
    sentences = zipf_sentences(NLP_TOKENS, NLP_VOCAB, seed=0)
    out = {}
    t0 = time.perf_counter()
    neg, w2v, pairs = nlp_word2vec(device, sentences, seed, negative=5)
    out["config3_negative"] = neg
    out["config3_hs"], _, _ = nlp_word2vec(device, sentences, seed,
                                           negative=0, pairs=pairs)
    out["config3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["card_vs_cpu"] = nlp_card_vs_cpu(device, sentences, pairs, seed)
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["config5"] = nlp_glove(device, sentences, seed)
    out["config5"]["seconds"] = time.perf_counter() - t0
    out["config3c"] = nlp_paragraph_vectors(device, seed, shared)
    t0 = time.perf_counter()
    out["rest"] = nlp_rest(device, seed, w2v, sentences)
    out["rest"]["seconds"] = time.perf_counter() - t0
    # the word-vector path reaches none of K1-K4
    after = {**flash_counts(), "paged_decode": paged.launches}
    out["k1_k4_launches"] = {k: after[k] - before[k] for k in after}
    out["card"] = nvidia_smi()
    out["ok"] = (all(out[k]["ok"] for k in ("config3_negative", "config3_hs",
                                            "card_vs_cpu", "config5",
                                            "config3c", "rest"))
                 and not any(out["k1_k4_launches"].values()))
    return out


# ------------------------------------------------------------------ rntn
#: SST's split sizes (Socher et al. 2013: 8,544 / 1,101 / 2,210), its
#: five classes, the reference RNTN's width (RNTN.java:70) and the
#: seeded corpus's vocabulary and lengths
SST_SPLITS = {"train": 8544, "dev": 1101, "test": 2210}
SST_VOCAB, SST_MAX_LEN, SST_MEAN_LEN = 16_000, 56, 19.0
SST_CLASSES, RNTN_HIDDEN = 5, 25
SYNTAX_LABELS = ("NP", "VP", "PP", "ADJP", "ADVP", "S", "SBAR", "PRT")
#: card vs CPU: (trees, epochs) of the simplified and per-category models
RNTN_PARITY = {"simplified": (1024, 3), "per_category": (256, 2)}
RNTN_EPOCHS, RNTN_PROBES = 50, 64
#: loss relative; tables, gradients and per-node values of the largest
#: |entry|; the root's probabilities from predict against output. T's
#: own bound is 1e-3 from this reading (PR 15 run 0, 1,024 trees, 3
#: epochs at lr 0.01, the history reset each epoch): T ended 1.5e-4 of
#: max |T| off at entry (0, 21, 25, 38), 4.7e-6 apart with |g| 9.0e-6
#: before the first update, while every loss agreed within 6.5e-8 and
#: every gradient within 7.9e-7; AdaGrad's step lr·g / (|g| + 1e-6) after
#: each reset moves an entry whose gradient has fallen near 0 by an amount
#: its rounding shifts up to lr / 1e-6 = 1e4 times
RNTN_TOL = {"loss": 1e-5, "tables": 1e-4, "T": 1e-3, "nodes": 1e-4,
            "root": 1e-6}
#: (c): a per-node or root difference may also reach this many times the
#: CPU's own float32 error against float64 (rntn_inference says why)
RNTN_SLACK = 4.0
RNTN_GROUPS = {"gemm": ("gemm", "gemv", "nvjet", "Kernel2", "dot_kernel"),
               "gather": ("index_select", "vectorized_gather",
                          "index_elementwise", "indexSelect"),
               "scatter": ("indexFuncSmallIndex", "indexFuncLargeIndex",
                           "index_add"),
               "cat": ("CatArrayBatchedCopy", "cat_"),
               "reduce": ("reduce_kernel",)}


def sst_corpus(seed) -> dict:
    """A seeded corpus of SST's shape (nothing downloaded): for each split
    its number of sentences, lengths drawn as round(Gamma(3, 19 / 3))
    clipped to [1, 56], tokens `w<rank>` drawn zipfian (p ∝ 1 / rank)
    from 16,000 words, and random-split binary bracketing (each span
    splits at a uniform point). Labels, on every node as SST labels every
    phrase: each word gets a seeded polarity p_w in {-2, ..., 2} (0 with
    probability 0.6, ±1 0.15 each, ±2 0.05 each), and a node's gold label
    is 2 + clip(sum of p_w over its span, -2, 2). Each word also gets one
    of 8 syntactic labels (its preterminal's), and a binary node takes
    label (3·left + right) mod 8, for the per-category model and the
    tagger. Returns {split: trees, "polarity", "tags"}."""
    from deeplearning4j_tpu_torch.nlp import Tree

    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, SST_VOCAB + 1)
    polarity = rng.choice([-2, -1, 0, 1, 2], size=SST_VOCAB,
                          p=[0.05, 0.15, 0.6, 0.15, 0.05])
    tags = rng.randint(0, len(SYNTAX_LABELS), SST_VOCAB)

    def label(score):
        return int(2 + min(2, max(-2, score)))

    def build(words, lo, hi):
        if hi - lo == 1:
            w = words[lo]
            leaf = Tree(value=f"w{w}")
            return (Tree(children=[leaf], gold_label=label(polarity[w]),
                         label=SYNTAX_LABELS[tags[w]]),
                    int(polarity[w]), int(tags[w]))
        k = rng.randint(lo + 1, hi)
        left, sl, tl = build(words, lo, k)
        right, sr, tr = build(words, k, hi)
        t = (3 * tl + tr) % len(SYNTAX_LABELS)
        return (Tree(children=[left, right], gold_label=label(sl + sr),
                     label=SYNTAX_LABELS[t]), sl + sr, t)

    out = {"polarity": polarity, "tags": tags}
    for split, n in SST_SPLITS.items():
        lengths = np.clip(np.rint(rng.gamma(3.0, SST_MEAN_LEN / 3.0, n)),
                          1, SST_MAX_LEN).astype(int)
        trees = []
        for length in lengths:
            words = rng.choice(SST_VOCAB, size=length, p=p / p.sum())
            trees.append(build(words, 0, length)[0])
        out[split] = trees
    return out


def rntn_pair(device, trees, seed, **kw):
    """A CPU RNTN and one on `device` with the same vocab, categories and
    parameters for `trees`, fresh AdaGrad histories, and each one's
    schedule of `trees`: ((cpu, its schedule), (card, its schedule))."""
    from deeplearning4j_tpu_torch.nlp import RNTN

    kw = dict(num_hidden=RNTN_HIDDEN, num_outs=SST_CLASSES, seed=seed, **kw)
    cpu = RNTN(device="cpu", **kw)
    cpu_sched = cpu.prepare(trees)
    card = RNTN(device=device, **kw)
    card.word_index = dict(cpu.word_index)
    card.cat_index = cpu.cat_index and dict(cpu.cat_index)
    card.ccat_index = cpu.ccat_index and dict(cpu.ccat_index)
    card.set_params(cpu.params())
    return (cpu, cpu_sched), (card, card.prepare(trees))


def worst_entries(cpu: dict, card: dict, grads: list) -> dict:
    """Per table, the entry furthest from the CPU's and the CPU's |g|
    there before each epoch's update."""
    out = {}
    for k, a in cpu.items():
        diff = (card[k].detach().cpu().double() - a.double()).abs()
        i = int(diff.argmax())
        out[k] = {"entry": [int(j) for j in np.unravel_index(
                      i, tuple(a.shape))],
                  "abs_diff": float(diff.reshape(-1)[i]),
                  "abs_g_by_epoch": [float(g[k].reshape(-1)[i].abs())
                                     for g in grads]}
    return out


def rntn_card_vs_cpu(device, corpus, seed) -> dict:
    """(a) From the same parameters, epoch by epoch: the gradient before
    each update and the loss, then every table and AdaGrad history."""
    out = {}
    for name, (n, epochs) in RNTN_PARITY.items():
        kw = ({} if name == "simplified" else
              dict(simplified_model=False, combine_classification=False))
        trees = corpus["train"][:n]
        pair = rntn_pair(device, trees, seed, **kw)
        (cpu, _), (card, _) = pair
        cpu_grads, grad_err, losses = [], {}, [[], []]
        for _ in range(epochs):
            grads = [m.loss_and_grads(m.params(), sched,
                                      m._class_weight_vec())[1]
                     for m, sched in pair]
            cpu_grads.append(grads[0])
            for k, e in table_errs(*grads).items():
                grad_err[k] = max(grad_err.get(k, 0.0), e)
            for i, (m, sched) in enumerate(pair):
                # the history reset every epoch, as fit's default
                # adagrad_reset_frequency of 1 does
                m._adagrad_hist = {k: torch.zeros_like(v)
                                   for k, v in m.params().items()}
                losses[i].append(float(m.step(sched,
                                              m._class_weight_vec())))
        losses = np.array(losses)
        errs = table_errs(cpu.params(), card.params())
        errs.update({f"hist_{k}": v for k, v in table_errs(
            cpu._adagrad_hist, card._adagrad_hist).items()})
        loss_rel = np.abs(losses[1] - losses[0]) / np.abs(losses[0])
        rec = {"trees": n, "epochs": epochs,
               "categories": [len(cpu.cat_index or [0]),
                              len(cpu.ccat_index or [0])],
               "loss_cpu": losses[0].tolist(), "loss_card": losses[1].tolist(),
               "loss_rel_err": loss_rel.tolist(), "grad_rel_err": grad_err,
               "rel_err": errs,
               "worst": worst_entries(cpu.params(), card.params(),
                                      cpu_grads)}
        rec["ok"] = bool((loss_rel <= RNTN_TOL["loss"]).all()
                         and max(grad_err.values()) <= RNTN_TOL["tables"]
                         and all(e <= RNTN_TOL.get(k, RNTN_TOL["tables"])
                                 for k, e in errs.items()))
        out[name] = rec
    out["tolerance"] = RNTN_TOL
    out["ok"] = all(out[k]["ok"] for k in RNTN_PARITY)
    return out


def rntn_fit(device, corpus, seed):
    """(b) The simplified model at the reference's width trained on the
    8,544 trees for RNTN_EPOCHS full-batch AdaGrad epochs: fit() is
    prepare + run_epochs + one read, and everything before the read is
    counted for syncs. One more epoch is profiled from a copy of the
    state, which is then put back. Returns (record, model)."""
    from deeplearning4j_tpu_torch.nlp import RNTN

    trees = corpus["train"]
    model = RNTN(num_hidden=RNTN_HIDDEN, num_outs=SST_CLASSES, seed=seed,
                 device=device)
    held = []
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: held.append(model.prepare(trees)))
    prepare_s = time.perf_counter() - t0
    sched = held[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs += count_syncs(lambda: held.append(model.run_epochs(
        sched, RNTN_EPOCHS)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = held[1].cpu().numpy()
    enc = model.encode(trees)
    nodes = int((enc.kind > 0).sum())
    state = dict(model._params), dict(model._adagrad_hist)
    prof = device_profile(lambda: model.run_epochs(sched, 1), iters=2,
                          groups=RNTN_GROUPS)
    model._params, model._adagrad_hist = state
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*model.params().values(),
                           *model._adagrad_hist.values()))
    depth = max(t.depth() for t in trees)
    rec = {"trees": len(trees), "nodes": nodes, "epochs": RNTN_EPOCHS,
           "words": len(model.word_index),
           "params": model.num_parameters(),
           "mean_length": float(np.mean([len(t.tokens()) for t in trees])),
           "levels": sched.n_levels, "tallest_depth": depth,
           "max_nodes": enc.max_nodes,
           "level_sizes": [sched.n_pre] + [lv.stop - lv.start
                                           for lv in sched.levels],
           "prepare_s": prepare_s, "epochs_s": wall,
           "ms_per_epoch": wall * 1e3 / RNTN_EPOCHS,
           "trees_per_s": len(trees) * RNTN_EPOCHS / wall,
           "nodes_per_s": nodes * RNTN_EPOCHS / wall,
           "kernels_per_epoch": prof.get("kernels_per_call"),
           "device_ms_per_epoch": prof.get("device_ms_per_call"),
           "busy_share": prof.get("device_busy_share"), "profile": prof,
           "syncs_before_read": syncs, "loss_epoch_1": float(losses[0]),
           "loss_last_epoch": float(losses[-1]), "finite": finite}
    rec["ok"] = bool(syncs == 0 and finite and losses[-1] < losses[0]
                     and sched.n_levels == depth < enc.max_nodes
                     and "device_ms_per_call" in prof)
    return rec, model


def rntn_node_errs(trees_a, trees_b) -> dict:
    """Max |a - b| over the internal nodes of matching trees, relative to
    the largest |b| (vectors, predictions), and each error's |a - b| /
    max(1, |b|)."""
    vec = pred = err = 0.0
    vec_scale = pred_scale = 1e-30
    for ta, tb in zip(trees_a, trees_b):
        for na, nb in zip(rntn_internal(ta), rntn_internal(tb)):
            vec = max(vec, float(np.abs(na.vector - nb.vector).max()))
            vec_scale = max(vec_scale, float(np.abs(nb.vector).max()))
            pred = max(pred, float(np.abs(na.prediction
                                          - nb.prediction).max()))
            pred_scale = max(pred_scale, float(np.abs(nb.prediction).max()))
            err = max(err, abs(na.error - nb.error) / max(1.0, abs(nb.error)))
    return {"vectors": vec / vec_scale, "predictions": pred / pred_scale,
            "errors": err}


def rntn_inference(device, corpus, model, seed) -> dict:
    """(c) output on the test trees in one batched forward; predict and
    forward_propagate_tree on RNTN_PROBES of them, against output's roots
    and against float32 and float64 CPU copies' per-node values. The
    trained model is itself sensitive to float32 rounding (PR 15 run 1,
    all 2,210 test trees: the card's predict against output up to 2.2e-5
    at a root, card against CPU vectors 3.4e-4; on the CPU, float32
    against float64 vectors 2.0e-4 and roots 4.9e-6), so each bound is
    RNTN_TOL's or RNTN_SLACK times the CPU's own float32 error against
    float64 on the same trees, whichever is larger."""
    from deeplearning4j_tpu_torch.nlp import RNTN

    test = corpus["test"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = model.output(test)
    output_ms = (time.perf_counter() - t0) * 1e3
    gold = np.array([t.gold_label for t in test])
    pred = probs.argmax(1)
    copies = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        m = RNTN(num_hidden=RNTN_HIDDEN, num_outs=SST_CLASSES, seed=seed,
                 device="cpu")
        m.word_index = dict(model.word_index)
        m._params = {k: v.detach().cpu().to(dtype)
                     for k, v in model.params().items()}
        copies[name] = m
    all_roots = {k: m.output(test) for k, m in copies.items()}
    probes = np.random.RandomState(seed + 21).choice(
        len(test), RNTN_PROBES, replace=False)
    trees = {k: [test[i].clone() for i in probes]
             for k in ("card", "f32", "f64")}
    predict_equal = sum(model.predict(t) == int(pred[i])
                        for t, i in zip(trees["card"], probes))
    for k in ("f32", "f64"):
        for t in trees[k]:
            copies[k].forward_propagate_tree(t)
    root_err = max(float(np.abs(t.prediction - probs[i]).max())
                   for t, i in zip(trees["card"], probes))
    f32_root = max(float(np.abs(a.prediction - b.prediction).max())
                   for a, b in zip(trees["f32"], trees["f64"]))
    card_cpu = rntn_node_errs(trees["card"], trees["f32"])
    f32_f64 = rntn_node_errs(trees["f32"], trees["f64"])
    counts = np.bincount(gold, minlength=SST_CLASSES)
    bounds = {"root": max(RNTN_TOL["root"], RNTN_SLACK * f32_root),
              **{k: max(RNTN_TOL["nodes"], RNTN_SLACK * v)
                 for k, v in f32_f64.items()}}
    rec = {"test_trees": len(test), "output_ms": output_ms,
           "root_accuracy": float((pred == gold).mean()),
           "majority_rate": float(counts.max() / counts.sum()),
           "root_classes": counts.tolist(), "probes": RNTN_PROBES,
           "predict_equal_output": int(predict_equal),
           "root_abs_err": root_err, "card_vs_cpu": card_cpu,
           "cpu_f32_vs_f64": {"root": f32_root, **f32_f64},
           "bounds": bounds,
           "all_roots_card_vs_cpu": float(np.abs(
               probs - all_roots["f32"]).max()),
           "all_roots_f32_vs_f64": float(np.abs(
               all_roots["f32"] - all_roots["f64"]).max())}
    rec["ok"] = bool(predict_equal == RNTN_PROBES
                     and root_err <= bounds["root"]
                     and all(card_cpu[k] <= bounds[k] for k in card_cpu)
                     and probs.shape == (len(test), SST_CLASSES)
                     and np.isfinite(probs).all())
    return rec


def rntn_internal(tree) -> list:
    """Internal nodes in a fixed order (pre-order)."""
    if tree.is_leaf():
        return []
    out = [tree]
    if not tree.is_preterminal():
        for c in tree.children:
            out.extend(rntn_internal(c))
    return out


def rntn_annotators(corpus) -> dict:
    """(d) The HMM tagger trained on the train yields with their words'
    syntactic labels, tagging the test yields; the lexicon of the seeded
    polarities classifying them; annotate_windows over one sentence."""
    from deeplearning4j_tpu_torch.nlp.pos import HmmPosTagger
    from deeplearning4j_tpu_torch.nlp.sentiment import SentimentLexicon
    from deeplearning4j_tpu_torch.nlp.windows import annotate_windows

    tags = corpus["tags"]

    def tagged(tree):
        return [(w, SYNTAX_LABELS[tags[int(w[1:])]]) for w in tree.tokens()]

    t0 = time.perf_counter()
    tagger = HmmPosTagger().train([tagged(t) for t in corpus["train"]])
    train_s = time.perf_counter() - t0
    yields = [t.tokens() for t in corpus["test"]]
    n_tokens = sum(map(len, yields))
    t0 = time.perf_counter()
    got = [tagger.tag(toks) for toks in yields]
    tag_s = time.perf_counter() - t0
    truth = [[tag for _, tag in tagged(t)] for t in corpus["test"]]
    correct = sum(a == b for g, tr in zip(got, truth) for a, b in zip(g, tr))
    lex = SentimentLexicon({f"w{w}": p / 2.0 for w, p in
                            enumerate(corpus["polarity"]) if p})
    t0 = time.perf_counter()
    classes = [lex.classify_tokens(toks) for toks in yields]
    lex_s = time.perf_counter() - t0
    wins = annotate_windows(yields[0], 5, tagger=tagger, lexicon=lex)
    rec = {"train_sentences": len(corpus["train"]), "train_s": train_s,
           "test_tokens": n_tokens, "tag_tokens_per_s": n_tokens / tag_s,
           "tag_accuracy": correct / n_tokens,
           "lexicon_tokens_per_s": n_tokens / lex_s,
           "lexicon_classes": {c: classes.count(c) for c in sorted(
               set(classes))},
           "windows": len(wins), "window_tags": wins[0].tags,
           "window_label": wins[0].label}
    first = tagger.tag(yields[0])
    rec["ok"] = (len(wins) == len(yields[0]) and correct > 0
                 and [w.focus_tag() for w in wins] == first)
    return rec


def phase_rntn(device, seed, shared=None):
    """Phase 21; see the module docstring. `shared` receives the trained
    parameters for phase 22."""
    before = {**flash_counts(), "paged_decode": paged.launches}
    t0 = time.perf_counter()
    corpus = sst_corpus(seed)
    out = {"corpus_s": time.perf_counter() - t0,
           "splits": {k: len(corpus[k]) for k in SST_SPLITS}}
    t0 = time.perf_counter()
    out["card_vs_cpu"] = rntn_card_vs_cpu(device, corpus, seed)
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fit"], model = rntn_fit(device, corpus, seed)
    out["fit"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["inference"] = rntn_inference(device, corpus, model, seed)
    out["inference"]["seconds"] = time.perf_counter() - t0
    out["annotators"] = rntn_annotators(corpus)
    if shared is not None:
        shared["rntn_params"] = model.params()
    # the tree path reaches none of K1-K4
    after = {**flash_counts(), "paged_decode": paged.launches}
    out["k1_k4_launches"] = {k: after[k] - before[k] for k in after}
    out["card"] = nvidia_smi()
    out["ok"] = (all(out[k]["ok"] for k in ("card_vs_cpu", "fit",
                                            "inference", "annotators"))
                 and not any(out["k1_k4_launches"].values()))
    return out


# -------------------------------------------------------------- clusters
KMEANS_K, KMEANS_ITERS, KMEANS_TOL = 20, 100, 1e-4
#: assignments: a point may differ only where its two nearest squared
#: distances are this close (relative); centroids of the largest |entry|
KMEANS_TIE, KMEANS_CENTROID_TOL = 1e-5, 1e-4
TSNE_PER_TOPIC, TSNE_CHECK_ITERS, TSNE_TOL = 100, 10, 1e-4
BH_POINTS, KNN_K, KNN_QUERIES = 256, 10, 64
CLUSTER_GROUPS = {"gemm": ("gemm", "gemv", "nvjet", "Kernel2", "dot_kernel"),
                  "reduce": ("reduce_kernel",),
                  "elementwise": ("elementwise",)}


def knn_topic_agreement(points, topics, k=10) -> float:
    """Mean share of each point's k nearest neighbours (euclidean, itself
    excluded) with its own topic."""
    x = np.asarray(points, np.float64)
    sq = (x * x).sum(1)
    d = sq[:, None] + sq[None, :] - 2 * x @ x.T
    np.fill_diagonal(d, np.inf)
    nn = np.argpartition(d, k, axis=1)[:, :k]
    return float((topics[nn] == topics[:, None]).mean())


def cluster_kmeans(device, x, topics, seed) -> dict:
    """(a) k-means card against CPU; ms and kernels an iteration."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.kmeans import lloyd_step

    kw = dict(k=KMEANS_K, max_iterations=KMEANS_ITERS, tol=KMEANS_TOL,
              seed=seed)
    t0 = time.perf_counter()
    cpu = KMeansClustering(device="cpu", **kw).fit(x)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = KMeansClustering(device=device, **kw).fit(x)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card._init_centroids(x, np.random.RandomState(seed))
    seeding_s = time.perf_counter() - t0
    a_cpu, a_card = cpu.predict(x), card.predict(x)
    d2 = ((x[:, None, :].astype(np.float64)
           - cpu.centroids[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= KMEANS_TIE * two[:, 1]
    differ = a_cpu != a_card
    cerr = float(np.abs(card.centroids - cpu.centroids).max()
                 / np.abs(cpu.centroids).max())
    xt = torch.from_numpy(x).to(device)
    ct = torch.from_numpy(card.centroids).to(device)
    prof = device_profile(lambda: lloyd_step(xt, ct), iters=10,
                          groups=CLUSTER_GROUPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = ct
    for _ in range(card.n_iter_):  # as fit iterates: a step, a read
        c, _, shift = lloyd_step(xt, c)
        float(shift)
    iter_ms = (time.perf_counter() - t0) * 1e3 / card.n_iter_
    purity = sum(np.bincount(topics[a_card == c]).max()
                 for c in np.unique(a_card)) / len(x)
    rec = {"points": list(x.shape), "k": KMEANS_K,
           "iterations_cpu": cpu.n_iter_, "iterations_card": card.n_iter_,
           "fit_s_cpu": cpu_s, "fit_s_card": card_s,
           "seeding_s": seeding_s, "ms_per_iteration": iter_ms,
           "kernels_per_iteration": prof.get("kernels_per_call"),
           "device_ms_per_iteration": prof.get("device_ms_per_call"),
           "busy_share": prof.get("device_busy_share"), "profile": prof,
           "assign_differ": int(differ.sum()),
           "assign_differ_not_tie": int((differ & ~tie).sum()),
           "centroid_rel_err": cerr, "topic_purity": float(purity)}
    rec["ok"] = (rec["assign_differ_not_tie"] == 0
                 and cerr <= KMEANS_CENTROID_TOL)
    return rec


def cluster_tsne(device, x, topics, seed):
    """(b) Exact t-SNE at the JAX package's defaults: card against CPU for
    the first iterations from the same start, then the whole run on the
    card. Returns (record, embedding)."""
    from deeplearning4j_tpu_torch.plot import Tsne

    card = Tsne(seed=seed, device=device)
    cpu = Tsne(seed=seed, device="cpu")
    n = x.shape[0]
    y0 = card._initial_y(n)
    t0 = time.perf_counter()
    p_host = cpu.affinities(x)
    affinity_s = time.perf_counter() - t0
    p = p_host.to(device)
    ys = {}
    for name, t, start in (("cpu", cpu, y0), ("card", card, y0),
                           ("cpu_nudged", cpu,
                            np.nextafter(y0, np.float32(np.inf)))):
        y = torch.from_numpy(np.array(start)).to(t.device)
        pt = p_host if t is cpu else p
        ys[name] = t.iterate(pt, y, torch.zeros_like(y), 0,
                             TSNE_CHECK_ITERS)[0].cpu().numpy()
    scale = float(np.abs(ys["cpu"]).max())
    err = float(np.abs(ys["card"] - ys["cpu"]).max()) / scale
    chaos = float(np.abs(ys["cpu_nudged"] - ys["cpu"]).max()) / scale
    y = torch.from_numpy(y0).to(device)
    v = torch.zeros_like(y)
    held = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: held.append(card.iterate(p, y, v, 0,
                                                         card.n_iter)))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    emb = held[0][0].cpu().numpy()
    prof = device_profile(lambda: card.iterate(p, y, v, 200, 210), iters=2,
                          groups=CLUSTER_GROUPS)
    rec = {"points": n, "perplexity": card.perplexity,
           "iterations": card.n_iter, "affinity_s": affinity_s,
           "loop_s": loop_s, "ms_per_iteration": loop_s * 1e3 / card.n_iter,
           "kernels_per_iteration": (prof.get("kernels_per_call") or 0) / 10,
           "device_ms_per_iteration":
               (prof.get("device_ms_per_call") or 0) / 10,
           "busy_share": prof.get("device_busy_share"), "profile": prof,
           "check_iterations": TSNE_CHECK_ITERS, "card_vs_cpu_rel": err,
           "cpu_vs_cpu_one_ulp_rel": chaos, "syncs_in_loop": syncs,
           "finite": bool(np.isfinite(emb).all()),
           "knn_topic_agreement_2d": knn_topic_agreement(emb, topics,
                                                         KNN_K),
           "knn_topic_agreement_128d": knn_topic_agreement(x, topics,
                                                           KNN_K)}
    rec["ok"] = (err <= TSNE_TOL and syncs == 0 and rec["finite"]
                 and "device_ms_per_call" in prof)
    return rec, emb


def cluster_indexes(x) -> dict:
    """(e) KD-tree and VP-tree k-NN against brute force."""
    from deeplearning4j_tpu_torch.clustering import KDTree, VPTree

    pts = x.astype(np.float64)
    rng = np.random.RandomState(22)
    queries = pts[rng.choice(len(pts), KNN_QUERIES, replace=False)] \
        + rng.randn(KNN_QUERIES, pts.shape[1]) * 0.01
    t0 = time.perf_counter()
    kd = KDTree.build(pts)
    vp = VPTree(pts, seed=0)
    build_s = time.perf_counter() - t0
    kd_ok = vp_ok = 0
    t0 = time.perf_counter()
    for q in queries:
        d = np.linalg.norm(pts - q, axis=1)
        want = np.argsort(d)[:KNN_K]
        got_kd = kd.knn(q, KNN_K)
        kd_ok += bool(np.allclose([dd for dd, _ in got_kd], d[want],
                                  rtol=1e-12, atol=0)
                      and all(np.array_equal(pt, pts[i])
                              for (_, pt), i in zip(got_kd, want)))
        got_vp = vp.knn(q, KNN_K)
        vp_ok += [i for _, i in got_vp] == want.tolist()
    query_s = time.perf_counter() - t0
    return {"points": len(pts), "queries": KNN_QUERIES, "k": KNN_K,
            "build_s": build_s, "query_s": query_s, "kdtree_equal": kd_ok,
            "vptree_equal": vp_ok,
            "ok": kd_ok == vp_ok == KNN_QUERIES}


def tsne_points(vecs) -> np.ndarray:
    """Rows of config 3c's vectors for t-SNE: the TSNE_PER_TOPIC most
    frequent words of each topic (labels left out)."""
    is_word = np.array([not w.startswith("__label__")
                        for w in vecs["words"]])
    return np.concatenate([
        idx[np.argsort(-vecs["counts"][idx], kind="stable")[:TSNE_PER_TOPIC]]
        for idx in (np.flatnonzero(is_word & (vecs["topics"] == t))
                    for t in range(PV_TOPICS))])


def barnes_hut_points(vecs, seed) -> np.ndarray:
    pick = tsne_points(vecs)
    return pick[np.random.RandomState(seed + 22).choice(
        len(pick), BH_POINTS, replace=False)]


def barnes_hut_embedding(points, seed):
    """(c)'s host run, in a process of its own: (embedding, seconds)."""
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne

    t0 = time.perf_counter()
    emb = BarnesHutTsne(seed=seed).calculate(points)
    return emb, time.perf_counter() - t0


def start_barnes_hut(vecs, seed):
    """Start (c) in a spawned process (host numpy for ~2 minutes), so it
    runs beside phase 21 and the rest of phase 22: (pool, future)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    pts = vecs["vectors"][barnes_hut_points(vecs, seed)]
    return pool, pool.submit(barnes_hut_embedding, pts, seed)


def phase_clusters(device, seed, shared):
    """Phase 22; see the module docstring. Takes (c) from the process
    `start_barnes_hut` started, when `shared` holds one."""
    from deeplearning4j_tpu_torch.datasets.api import DataSet
    from deeplearning4j_tpu_torch.plot import serve_coords
    from deeplearning4j_tpu_torch.utils import from_bytes, to_bytes
    from deeplearning4j_tpu_torch.utils.interop import to_device

    before = {**flash_counts(), "paged_decode": paged.launches}
    vecs = shared["config3c"]
    x, topics = vecs["vectors"], vecs["topics"]
    out = {}
    t0 = time.perf_counter()
    out["kmeans"] = cluster_kmeans(device, x, topics, seed)
    out["kmeans"]["seconds"] = time.perf_counter() - t0
    pick = tsne_points(vecs)
    t0 = time.perf_counter()
    out["tsne"], emb = cluster_tsne(device, x[pick], topics[pick], seed)
    out["tsne"]["seconds"] = time.perf_counter() - t0
    pool, future = shared.pop("barnes_hut", None) or start_barnes_hut(
        vecs, seed)
    t0 = time.perf_counter()
    try:
        bh, bh_s = future.result()
    finally:
        pool.shutdown()
    bh_topics = topics[barnes_hut_points(vecs, seed)]
    out["barnes_hut"] = {"points": BH_POINTS, "iterations": 300,
                         "seconds": bh_s,
                         "waited_s": time.perf_counter() - t0,
                         "knn_topic_agreement_2d": knn_topic_agreement(
                             bh, bh_topics, KNN_K),
                         "ok": bool(np.isfinite(bh).all())
                         and bh.shape == (BH_POINTS, 2)}
    labels = [f"t{t}" for t in topics[pick]]
    handle = serve_coords(emb, labels=labels)
    try:
        data = json.loads(http_get(
            f"http://127.0.0.1:{handle.port}/api/coords")[1])
    finally:
        handle.close()
    out["render_server"] = {
        "coords": len(data["coords"]),
        "ok": (len(data["coords"]) == len(pick)
               and data["labels"] == labels
               and np.allclose(data["coords"], emb.astype(np.float64))
               and not handle.thread.is_alive())}
    t0 = time.perf_counter()
    out["indexes"] = cluster_indexes(x)
    out["indexes"]["seconds"] = time.perf_counter() - t0
    onehot = np.eye(PV_TOPICS, dtype=np.float32)[topics]
    f, y = to_device(DataSet(x, onehot), device)
    out["interop"] = {"device": str(f.device), "shapes": [list(f.shape),
                                                           list(y.shape)],
                      "ok": f.is_cuda and y.is_cuda and bool(torch.equal(
                          f.cpu(), torch.from_numpy(x)))}
    params = shared["rntn_params"]
    back = from_bytes(to_bytes(params))
    out["serialization"] = {
        "bytes": len(to_bytes(params)), "tables": sorted(back),
        "ok": set(back) == set(params) and all(
            np.array_equal(back[k].view(np.uint32),
                           params[k].cpu().numpy().view(np.uint32))
            for k in params)}
    after = {**flash_counts(), "paged_decode": paged.launches}
    out["k1_k4_launches"] = {k: after[k] - before[k] for k in after}
    out["card"] = nvidia_smi()
    out["ok"] = (all(out[k]["ok"] for k in (
        "kmeans", "tsne", "barnes_hut", "render_server", "indexes",
        "interop", "serialization"))
        and not any(out["k1_k4_launches"].values()))
    return out


def device_profile(fn, iters: int, groups=None) -> dict:
    """Device time by kernel over `iters` calls (torch.profiler, CUDA
    activity only counted from kernel events), and the device's busy
    share of the profiled wall time; `groups` ({label: substring of the
    kernel name, or a tuple of them}) adds each group's share and calls,
    a kernel counted in the first group it matches.
    "not measured" when the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        return {"device_time": "not measured"}
    total_us = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    def group_of(key):
        for label, sub in (groups or {}).items():
            if any(s in key for s in ((sub,) if isinstance(sub, str)
                                      else sub)):
                return label
        return None

    shares = {label: {"ms_per_call": sum(us for k, us, _ in rows
                                         if group_of(k) == label)
                      / 1e3 / iters,
                      "share": sum(us for k, us, _ in rows
                                   if group_of(k) == label) / total_us,
                      "calls_per_call": sum(c for k, _, c in rows
                                            if group_of(k) == label) / iters}
              for label in (groups or {})}
    return {"iters": iters, "groups": shares,
            "wall_ms_per_call": wall * 1e3 / iters,
            "device_ms_per_call": total_us / 1e3 / iters,
            "device_busy_share": total_us / 1e6 / wall,
            "kernels_per_call": sum(c for _, _, c in rows) / iters,
            "top": [{"name": k[:90], "ms_per_call": us / 1e3 / iters,
                     "share": us / total_us, "calls_per_call": c / iters}
                    for k, us, c in rows[:8]]}


_MANGLED = re.compile(
    r"\d+((?:flash|paged)_[a-z_]+kernel(?:_wgmma)?)I(\w+?)EE")
_TEMPLATE_ARG = re.compile(r"(13__nv_bfloat16)|(f)|Li(\d+)")


def function_name(mangled: str) -> str:
    """`flash_fwd_kernel_wgmma<128>` for its mangled name."""
    m = _MANGLED.search(mangled)
    if not m:
        return mangled
    args = ["bf16" if bf else "float" if f else n
            for bf, f, n in _TEMPLATE_ARG.findall(m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def kernel_functions(lib) -> dict:
    """Per kernel function of the built library: registers and spill bytes
    from ptxas's report in build.log, and the tensor-core instructions in
    its SASS (`cuobjdump -sass`): HGMMA is wgmma, HMMA mma.sync."""
    funcs, name = {}, None
    log = (lib.parent / "build.log").read_text()
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = function_name(m.group(1))
            funcs[name] = {"registers": None, "spill_bytes": None,
                           "hgmma": 0, "hmma": 0}
        elif name and "spill stores" in ln:
            funcs[name]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", ln))
        elif name and "Used" in ln and "registers" in ln:
            funcs[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    name = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = function_name(m.group(1))
            funcs.setdefault(name, {"registers": None, "spill_bytes": None,
                                    "hgmma": 0, "hmma": 0})
        elif name and "HGMMA" in ln:
            funcs[name]["hgmma"] += 1
        elif name and "HMMA" in ln:
            funcs[name]["hmma"] += 1
    return funcs


# ------------------------------------------------------------- parallel
PAR_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
#: the 4-rank group of phase 19 (b): ranks, hard limit (s) of the group
#: and of the NCCL probe
PAR_RANKS, PAR_LIMIT, NCCL_PROBE_LIMIT = 4, 240.0, 60.0
#: the ring at the 110M LM's attention shape: B, H, T, hd (bf16)
RING_B, RING_H, RING_T, RING_HD = 8, 8, 1024, 128
#: ring gates, bf16: the forward elementwise |out - ref| <= ATOL + RTOL
#: |ref| (RTOL 2^-6 is two to four bf16 ulps of |ref|; ATOL 2^-7, two
#: ulps of the unit-scale values a row averages, covers outputs near 0,
#: where that average cancels), and dQ/dK/dV relative to the largest
#: |reference| value
RING_FWD_ATOL, RING_FWD_RTOL, RING_BWD_TOL = 2.0 ** -7, 2.0 ** -6, 3e-2
#: |ref| bins the ring's forward error is also reported in
RING_FWD_BINS = (0.0, 2.0 ** -4, 2.0 ** -2, 1.0, 2.0, 4.0)
#: DP and TP at 4 ranks against one process, bf16 products: the params'
#: distance ||p - p_ref|| over the training's own movement ||p_ref - p0||
#: (AdaGrad's step is divided by the 4096-row batch, so the params move
#: ~1e-4 each and an absolute tolerance cannot see a broken trainer)
PAR_MOVE_TOL = 0.05
#: pipeline and experts (float32 on the card): relative to the largest
#: |reference| value (sums in another order, TF32 off)
PAR_F32_TOL = 1e-5
PIPE_STAGES, PIPE_D, PIPE_M, PIPE_B = 4, 1024, 8, 512
MOE_E, MOE_D, MOE_H, MOE_N = 4, 1024, 4096, 4096


def rel_err(a, b) -> float:
    return max_err(a, b) / max(float(b.float().abs().max().item()), 1e-30)


def ring_fwd_err(got, ref) -> dict:
    """The ring's forward against a reference: the largest |got - ref|,
    that over the gate's limit ATOL + RTOL |ref| (<= 1 passes), and the
    largest |got - ref| in each |ref| bin of RING_FWD_BINS."""
    got, ref = got.detach().float(), ref.detach().float()
    err = (got - ref).abs()
    mag = ref.abs()
    by_bin = {}
    for lo, hi in zip(RING_FWD_BINS, RING_FWD_BINS[1:] + (math.inf,)):
        sel = (mag >= lo) & (mag < hi)
        by_bin[f"[{lo:g},{hi:g})"] = (float(err[sel].max())
                                      if bool(sel.any()) else None)
    return {"max_abs_err": float(err.max()),
            "worst_over_limit": float(
                (err / (RING_FWD_ATOL + RING_FWD_RTOL * mag)).max()),
            "max_abs_err_by_ref_bin": by_bin}


def moved_rel(p, ref, p0) -> float:
    """||p - ref|| / ||ref - p0||: how far `p` lies from the reference
    training's end, in units of that training's own movement."""
    p, ref, p0 = (np.asarray(a, np.float64) for a in (p, ref, p0))
    return float(np.linalg.norm(p - ref) / np.linalg.norm(ref - p0))


def par_world1_reference(device, seed):
    """Config 1's params before and after 2 epochs of MultiLayerNetwork.
    fit on the card (bit-equal to DataParallelTrainer at world size 1,
    phase 19 (a)), and after 2 epochs on a quarter of every batch (rank
    0's 1,024 rows): the reference of (b)'s DP and TP and a training the
    gate must reject."""
    batch, n_batches, x_np, y_np = mlp_batches(seed + 19)
    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    p0 = net.params().cpu().numpy()
    net.fit(ListDataSetIterator(DataSet(x_np, y_np), batch), epochs=2)
    quarter = np.concatenate([np.arange(i * batch, i * batch + batch
                                        // PAR_RANKS)
                              for i in range(n_batches)])
    net_q = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    net_q.fit(ListDataSetIterator(DataSet(x_np[quarter], y_np[quarter]),
                                  batch // PAR_RANKS), epochs=2)
    torch.cuda.synchronize()
    return {"p0": p0, "world1": net.params().cpu().numpy(),
            "quarter": net_q.params().cpu().numpy()}


def par_dp_runs(device, seed, mesh):
    """(a): BASELINE config 1 (784-2048-1024-10, bf16 products, AdaGrad
    lr 0.05, 16 batches of 4096, 2 epochs) under DataParallelTrainer at
    world size 1 on NCCL against MultiLayerNetwork.fit through its
    DeviceFeed, ZeRO-1 against DP, averaging against the same wave run
    by hand; ms a step by CUDA events; a DP epoch under sync-debug
    "error"."""
    from deeplearning4j_tpu_torch.optimize.updater import \
        NetworkGradientUpdater
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   ParameterAveragingTrainer,
                                                   ShardedUpdateTrainer)

    batch, n_batches, x_np, y_np = mlp_batches(seed + 19)
    conf = mlp_conf("bfloat16")

    def it():
        return ListDataSetIterator(DataSet(x_np, y_np), batch)

    def epochs_ms(fit_epoch, n):
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fit_epoch()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / n_batches)
        return out

    net_fit, net_dp, net_z, net_a, net_h = (
        MultiLayerNetwork(conf, device=device) for _ in range(5))
    p0 = net_fit.params()
    for net in (net_dp, net_z, net_a, net_h):
        net.set_parameters(p0)
    fit_ms = epochs_ms(lambda: net_fit.fit(it()), 2)
    dp = DataParallelTrainer(net_dp, mesh)
    dp_ms = epochs_ms(lambda: dp.fit(it()), 2)
    dp_diff = bitwise_diff(net_dp, net_fit)
    dp_diff.pop("iteration_count", None)  # the trainer keeps the net's
    dp_max = max_err(net_dp.params(), net_fit.params())
    ShardedUpdateTrainer(net_z, mesh).fit(it(), epochs=2)
    z_err = max_err(net_z.params(), net_dp.params())
    scores = {"fit": net_fit.score(x_np[:batch], y_np[:batch]),
              "dp": net_dp.score(x_np[:batch], y_np[:batch])}
    torch.cuda.set_sync_debug_mode("error")
    try:
        dp.fit(it())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # averaging: K = 4 local steps per wave, no batch count to the
    # updater (the JAX package's wave); at world 1 the pmean is the
    # identity, so the same steps by hand are its reference
    ParameterAveragingTrainer(net_a, mesh, local_steps=4).fit(it())
    upd = NetworkGradientUpdater.for_network(net_h)
    state = upd.init(net_h.param_table)
    x_dev = torch.from_numpy(x_np).to(device)
    y_dev = torch.from_numpy(y_np).to(device)
    for i in range(n_batches):
        params = net_h.param_table
        leaves = [p for t in params.values() for p in t.values()]
        loss = net_h.loss_fn(params, x_dev[i * batch:(i + 1) * batch],
                             y_dev[i * batch:(i + 1) * batch], training=True)
        g = iter(torch.autograd.grad(loss, leaves))
        grads = {k: {n: next(g) for n in t} for k, t in params.items()}
        with torch.no_grad():
            updates, state = upd.update(grads, state, params)
            for p, u in zip(leaves, [u for t in updates.values()
                                     for u in t.values()]):
                p.sub_(u)
    avg_err = max_err(net_a.params(), net_h.params())
    finite = all(bool(torch.isfinite(n.params()).all())
                 for n in (net_dp, net_z, net_a))
    bit_equal = not dp_diff
    ok = ((bit_equal or dp_max <= TOL[torch.bfloat16]) and z_err <= 1e-5
          and avg_err <= 1e-5 and finite)
    return {"batch": batch, "batches": n_batches, "epochs": 2,
            "dp_bit_equal_to_fit": bit_equal, "dp_diff_leaves": dp_diff,
            "dp_max_abs_diff_to_fit": dp_max,
            "zero1_max_abs_err_to_dp": z_err,
            "averaging_max_abs_err_to_same_wave": avg_err,
            "averaging_reference": "the wave's steps by hand (no batch "
            "count to the updater, as the JAX package's wave); fit() "
            "divides AdaGrad's step by the batch and is not its reference",
            "fit_ms_per_step": fit_ms, "dp_ms_per_step": dp_ms,
            "dp_over_fit": dp_ms[-1] / fit_ms[-1],
            "no_host_sync_in_dp_epoch": True,
            "score_after_2_epochs": scores,
            "params": p0.numel(), "ok": ok}


def par_attention(device, seed, mesh):
    """(a): the attention stack (bf16, batch 1024, 8 batches) under
    DataParallelTrainer: K1, K2 and K3 once a step, the params bit-equal
    to fit's."""
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    batch, n_batches, _ = ML_TRAIN["attention"]
    x_np, y_np = synthetic_mnist(batch * n_batches, seed=seed + 20)
    conf = attention_conf("bfloat16")
    net_fit, net_dp = (MultiLayerNetwork(conf, device=device)
                       for _ in range(2))
    net_dp.set_parameters(net_fit.params())
    net_fit.fit(ListDataSetIterator(DataSet(x_np, y_np), batch))
    torch.cuda.synchronize()
    reset_flash_counts()
    DataParallelTrainer(net_dp, mesh).fit(
        ListDataSetIterator(DataSet(x_np, y_np), batch))
    torch.cuda.synchronize()
    launches = flash_counts()
    diff = bitwise_diff(net_dp, net_fit)
    diff.pop("iteration_count", None)
    want = {k: n_batches for k in launches}
    return {"batch": batch, "steps": n_batches, "launches": launches,
            "launches_expected": want, "bit_equal_to_fit": not diff,
            "max_abs_diff_to_fit": max_err(net_dp.params(),
                                           net_fit.params()),
            "ok": launches == want and not diff}


def par_checkpoint(device, seed, mesh):
    """(a): a guarded DP run autosaving through ShardedModelSaver(mesh=,
    strategy="dp") and a ZeRO-1 autosave restore bit-equal
    (restore_params_for, restore_network, restore_flat_state)."""
    from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                     restore_network,
                                                     restore_params_for)
    from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   ShardedUpdateTrainer)
    from deeplearning4j_tpu_torch.parallel.mesh import replicated

    batch, n_batches, x_np, y_np = mlp_batches(seed + 21)
    conf = mlp_conf("bfloat16")
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    out = {}
    try:
        net = MultiLayerNetwork(conf, device=device)
        root = str(PAR_DIR / "dp")
        with ShardedModelSaver(root, mesh=mesh, strategy="dp") as saver:
            DataParallelTrainer(net, mesh).fit(
                ListDataSetIterator(DataSet(x_np, y_np), batch),
                guardian=GuardianPolicy(check_every=4),
                checkpoint_every=n_batches, saver=saver)
        placed = restore_params_for(root, replicated(mesh))
        restored, info = restore_network(root, device=device)
        out["dp"] = {
            "params_diff": tree_diff(placed, net.param_table),
            "state_diff": bitwise_diff(restored, net),
            "position": info["iterator_position"], "mesh": info["mesh"]}
        out["dp"]["state_diff"].pop("iteration_count", None)
        net = MultiLayerNetwork(conf, device=device)
        root = str(PAR_DIR / "zero1")
        tr = ShardedUpdateTrainer(net, mesh)
        with ShardedModelSaver(root, mesh=mesh, strategy="zero1") as saver:
            tr.fit(ListDataSetIterator(DataSet(x_np, y_np), batch),
                   checkpoint_every=n_batches, saver=saver)
        restored, info = restore_network(root, device=device)
        tr2 = ShardedUpdateTrainer(restored, mesh)
        tr2.restore_flat_state(info["metadata"])
        flat_equal = all(torch.equal(a, b) for a, b in
                         zip(tr._flat_state, tr2._flat_state))
        out["zero1"] = {"params_diff": tree_diff(restored.param_table,
                                                 net.param_table),
                        "flat_state_bit_equal": flat_equal,
                        "position": info["iterator_position"],
                        "mesh": info["mesh"]}
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)
    out["ok"] = (not out["dp"]["params_diff"] and not out["dp"]["state_diff"]
                 and out["dp"]["position"] == n_batches
                 and not out["zero1"]["params_diff"]
                 and out["zero1"]["flat_state_bit_equal"]
                 and out["zero1"]["position"] == n_batches)
    return out


def ring_rank_checks(device, backend, seed):
    """(b), one rank: ring_attention(local="flash") on this rank's 256
    positions of the LM's attention shape, causal and not, forward and
    backward; its K1-K3 launches; against one flash_attention over the
    whole sequence (forward and backward) and the einsum ring."""
    from deeplearning4j_tpu_torch.attention.ring import ring_attention
    from deeplearning4j_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": PAR_RANKS}, device=device, backend=backend)
    i, tl = mesh.axis_index("sp"), RING_T // PAR_RANKS
    gen = torch.Generator().manual_seed(seed + 22)
    q, k, v, do = (torch.randn(RING_B, RING_H, RING_T, RING_HD,
                               generator=gen).to(device, torch.bfloat16)
                   for _ in range(4))
    sl = slice(i * tl, (i + 1) * tl)
    out = {}
    for causal in (True, False):
        shards = [a[:, :, sl].contiguous().requires_grad_()
                  for a in (q, k, v)]
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        ring = ring_attention(*shards, mesh, axis="sp", causal=causal,
                              local="flash")
        ring.backward(do[:, :, sl].contiguous())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = flash_counts()
        full = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        ref = flash.flash_attention(*full, causal)
        ref.backward(do)
        with torch.no_grad():
            einsum = ring_attention(*(s.detach() for s in shards), mesh,
                                    axis="sp", causal=causal,
                                    local="einsum")
        out["causal" if causal else "not_causal"] = {
            "launches": launches, "fwd_bwd_ms": ms,
            "fwd_err_to_whole_flash": ring_fwd_err(ring, ref[:, :, sl]),
            "fwd_err_to_einsum_ring": ring_fwd_err(ring, einsum),
            "grad_rel_err_to_whole_flash": [
                rel_err(s.grad, f.grad[:, :, sl])
                for s, f in zip(shards, full)]}
    return out


def par_train_rank(device, backend, seed, trainer, axes):
    """(b), one rank: BASELINE config 1 trained 2 epochs by `trainer` on
    the mesh `axes` (rank 0 returns the params and the score)."""
    from deeplearning4j_tpu_torch import parallel

    batch, n_batches, x_np, y_np = mlp_batches(seed + 19)
    mesh = parallel.make_mesh(axes, device=device, backend=backend)
    net = MultiLayerNetwork(mlp_conf("bfloat16"), device=device)
    cls = getattr(parallel, trainer)
    t0 = time.perf_counter()
    cls(net, mesh).fit(ListDataSetIterator(DataSet(x_np, y_np), batch),
                       epochs=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = net.score(x_np[:batch], y_np[:batch])
    return {"params": net.params().cpu().numpy() if mesh.rank == 0 else None,
            "score": score, "wall_s": wall}


def pipeline_rank_checks(device, backend, seed):
    """(b), one rank: 4 stages of d 1024, 8 microbatches of 512:
    pipeline_apply and one pipeline_grad_step against sequential_apply
    and its autograd step (float32)."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel import pipeline as pipe

    mesh = make_mesh({"pipe": PIPE_STAGES}, device=device, backend=backend)
    gen = torch.Generator().manual_seed(seed + 23)
    params = pipe.init_pipeline_params(gen, PIPE_STAGES, PIPE_D,
                                       device=device)
    xm, ym = (torch.randn(PIPE_M, PIPE_B, PIPE_D, generator=gen).to(device)
              for _ in range(2))
    t0 = time.perf_counter()
    out = pipe.pipeline_apply(params, xm, mesh)
    new, loss = pipe.pipeline_grad_step(params, xm, ym, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    seq = torch.stack([pipe.sequential_apply(p, xm[j])
                       for j in range(PIPE_M)])
    ref_loss = torch.mean((seq - ym) ** 2)
    grads = torch.autograd.grad(ref_loss, [p["W"], p["b"]])
    ref = {n: params[n] - 0.1 * g for n, g in zip(("W", "b"), grads)}
    ref_loss = float(ref_loss.detach())
    return {"fwd_rel_err": rel_err(out, seq.detach()),
            "loss_rel_err": abs(float(loss) - ref_loss) / abs(ref_loss),
            "param_rel_err": max(rel_err(new[n], ref[n]) for n in ref),
            "wall_s": wall}


def experts_rank_checks(device, backend, seed):
    """(b), one rank: E 4, d_in 1024, d_hidden 4096, 4096 tokens: dense
    moe_apply and moe_apply_a2a at capacity 4 against moe_reference; at
    capacity 1 the dropped count against this rank's own routing."""
    from deeplearning4j_tpu_torch.parallel import expert_parallel as ep
    from deeplearning4j_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"expert": PAR_RANKS}, device=device,
                     backend=backend)
    gen = torch.Generator().manual_seed(seed + 24)
    params = ep.init_moe_params(gen, MOE_E, MOE_D, MOE_H, device=device)
    x = torch.randn(MOE_N, MOE_D, generator=gen).to(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = ep.moe_reference(params, x)
        dense = ep.moe_apply(params, x, mesh)
        a2a, dropped4 = ep.moe_apply_a2a(params, x, mesh, capacity_factor=4.0,
                                         return_stats=True)
        _, dropped1 = ep.moe_apply_a2a(params, x, mesh, capacity_factor=1.0,
                                       return_stats=True)
        n_loc = MOE_N // PAR_RANKS
        cap = max(1, int(-(-1.0 * n_loc // MOE_E)))
        i = mesh.axis_index("expert")
        choice = torch.argmax(x[i * n_loc:(i + 1) * n_loc] @ params["gate"],
                              dim=-1)
        mine = int(torch.clamp_min(torch.bincount(choice, minlength=MOE_E)
                                   - cap, 0).sum())
    torch.cuda.synchronize()
    return {"dense_rel_err": rel_err(dense, ref),
            "a2a_rel_err": rel_err(a2a, ref), "dropped_cf4": int(dropped4),
            "dropped_cf1": int(dropped1), "my_dropped_cf1": mine,
            "wall_s": time.perf_counter() - t0}


def parallel_rank(rank, seed, per_card):
    """Phase 19 (b): one of PAR_RANKS spawned ranks, either sharing card 0
    over gloo or on card `rank` over NCCL, the meshes' default there (the
    kernel library was built by the parent before the ranks started, so
    each rank only loads it)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    device = torch.device("cuda", rank if per_card else 0)
    backend = None if per_card else "gloo"
    torch.cuda.set_device(device)
    _build.library()
    out = {"ring": ring_rank_checks(device, backend, seed)}
    out["dp"] = par_train_rank(device, backend, seed, "DataParallelTrainer",
                               {"data": PAR_RANKS})
    out["tp"] = par_train_rank(device, backend, seed,
                               "TensorParallelTrainer",
                               {"data": 2, "model": 2})
    out["pipeline"] = pipeline_rank_checks(device, backend, seed)
    out["experts"] = experts_rank_checks(device, backend, seed)
    out["host_staged_bytes"] = collectives.host_staged_bytes
    return out


def nccl_probe_rank(rank):
    """Whether NCCL takes two ranks of one communicator on one card."""
    from deeplearning4j_tpu_torch.parallel import collectives, make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh({"data": 2}, device=torch.device("cuda", 0),
                     backend="nccl")
    t = torch.ones(4, device="cuda")
    collectives.all_reduce_(t, mesh, "data")
    return float(t[0].item())


def ring_kernel_timing(device, timer, seed):
    """K1, K2 and K3 at the ring's shard shape (B*H 64, Tq = Tk = 256,
    hd 128, bf16), causal (the diagonal shard) and not (a past shard)."""
    gen = torch.Generator().manual_seed(seed + 25)
    rows = {}
    for causal in (True, False):
        for name, row in kernel_timing_at(
                device, timer, gen, RING_B, RING_H, RING_T // PAR_RANKS,
                RING_HD, causal, "the ring's shard shape").items():
            rows.setdefault(name, {})[
                "causal" if causal else "not_causal"] = row
    return rows


def phase_parallel(device, seed):
    """Phase 19; see the module docstring."""
    from deeplearning4j_tpu_torch.parallel import make_mesh, multihost
    from deeplearning4j_tpu_torch.testing.ranks import free_port

    out = {}
    # (a) world size 1 on NCCL, in this process
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, timeout=60)
    try:
        mesh = make_mesh({"data": 1}, device=device)
        out["mesh"] = {"axes": mesh.shape, "backend": mesh.backend}
        out["config1"] = par_dp_runs(device, seed, mesh)
        out["attention"] = par_attention(device, seed, mesh)
        out["checkpoint"] = par_checkpoint(device, seed, mesh)
    finally:
        multihost.shutdown()
    out["ranks"] = par_ranks(device, seed, per_card=False)
    out["ok"] = (out["config1"]["ok"] and out["attention"]["ok"]
                 and out["checkpoint"]["ok"] and out["ranks"]["ok"])
    return out


def par_ranks(device, seed, per_card):
    """Phase 19 (b): PAR_RANKS spawned ranks, sharing the card over gloo
    or one a card over NCCL (`per_card`), against the whole-sequence
    flash, the einsum ring, one process's fit, sequential_apply and
    moe_reference."""
    from deeplearning4j_tpu_torch.testing.ranks import RankError, run_ranks

    ref = par_world1_reference(device, seed)
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_RANKS, seed, per_card,
                      start="spawn", timeout=PAR_LIMIT)
    group_s = time.perf_counter() - t0
    ring = {}
    for mode in ("causal", "not_causal"):
        rows = [r["ring"][mode] for r in ranks]
        ring[mode] = {
            "launches": {k: sum(r["launches"][k] for r in rows)
                         for k in rows[0]["launches"]},
            "launches_by_rank": [r["launches"] for r in rows],
            **{to: {"max_abs_err": max(r[to]["max_abs_err"] for r in rows),
                    "worst_over_limit": max(r[to]["worst_over_limit"]
                                            for r in rows),
                    "max_abs_err_by_ref_bin": {
                        b: max((r[to]["max_abs_err_by_ref_bin"][b]
                                for r in rows if r[to][
                                    "max_abs_err_by_ref_bin"][b] is not None),
                               default=None)
                        for b in rows[0][to]["max_abs_err_by_ref_bin"]}}
               for to in ("fwd_err_to_whole_flash",
                          "fwd_err_to_einsum_ring")},
            "grad_rel_err_to_whole_flash": max(
                max(r["grad_rel_err_to_whole_flash"]) for r in rows),
            "fwd_bwd_ms_by_rank": [r["fwd_bwd_ms"] for r in rows]}
    want = {"causal": PAR_RANKS * (PAR_RANKS + 1) // 2,
            "not_causal": PAR_RANKS * PAR_RANKS}
    dp4, tp = ranks[0]["dp"]["params"], ranks[0]["tp"]["params"]
    moved = {"dp_to_world1": moved_rel(dp4, ref["world1"], ref["p0"]),
             "tp_to_world1": moved_rel(tp, ref["world1"], ref["p0"]),
             "tp_to_dp": moved_rel(tp, dp4, ref["p0"]),
             "control_quarter_batch": moved_rel(ref["quarter"],
                                                ref["world1"], ref["p0"]),
             "control_untrained": moved_rel(ref["p0"], ref["world1"],
                                            ref["p0"])}
    tp_rel = abs(ranks[0]["tp"]["score"] - ranks[0]["dp"]["score"]) / abs(
        ranks[0]["dp"]["score"])
    pipe = {k: max(r["pipeline"][k] for r in ranks)
            for k in ("fwd_rel_err", "loss_rel_err", "param_rel_err")}
    experts = {k: max(r["experts"][k] for r in ranks)
               for k in ("dense_rel_err", "a2a_rel_err")}
    experts["dropped_cf4"] = ranks[0]["experts"]["dropped_cf4"]
    experts["dropped_cf1"] = ranks[0]["experts"]["dropped_cf1"]
    experts["dropped_cf1_expected"] = sum(r["experts"]["my_dropped_cf1"]
                                         for r in ranks)
    staged = [r["host_staged_bytes"] for r in ranks]
    b = {
        "n": PAR_RANKS, "start": "spawn",
        "backend": "nccl, one rank a card" if per_card
        else "gloo, the ranks sharing card 0",
        "group_wall_s": group_s, "host_staged_bytes_by_rank": staged,
        "ring": ring, "ring_launches_expected": want,
        "ring_fwd_limit": f"|out - ref| <= {RING_FWD_ATOL:g} + "
                          f"{RING_FWD_RTOL:g} |ref|",
        "params_moved_rel": moved, "params_moved_rel_tol": PAR_MOVE_TOL,
        "dp": {"max_abs_err_to_world1": float(
                   np.abs(dp4 - ref["world1"]).max()),
               "max_abs_movement": float(
                   np.abs(ref["world1"] - ref["p0"]).max()),
               "score": ranks[0]["dp"]["score"],
               "wall_s_by_rank": [r["dp"]["wall_s"] for r in ranks]},
        "tp": {"score": ranks[0]["tp"]["score"], "score_rel_err_to_dp":
               tp_rel, "wall_s_by_rank": [r["tp"]["wall_s"]
                                          for r in ranks]},
        "pipeline": pipe, "experts": experts,
        "timing_note": "one rank a card" if per_card else
        "four processes time-slice one card: no speed here is gated or "
        "a scaling figure"}
    if not per_card:  # does NCCL take two ranks of one communicator?
        try:
            run_ranks(nccl_probe_rank, 2, start="spawn",
                      timeout=NCCL_PROBE_LIMIT)
            probe = {"accepted": True}
        except RankError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            probe = {"accepted": False, "error": lines[-1][:300]}
        b["nccl_two_ranks_one_card"] = probe
    b["ok"] = (all(ring[m]["launches"] == {k: want[m] for k in
                                           ring[m]["launches"]}
                   for m in ring)
               and all(ring[m][to]["worst_over_limit"] <= 1.0 for m in ring
                       for to in ("fwd_err_to_whole_flash",
                                  "fwd_err_to_einsum_ring"))
               and all(ring[m]["grad_rel_err_to_whole_flash"]
                       <= RING_BWD_TOL for m in ring)
               and max(moved["dp_to_world1"], moved["tp_to_world1"],
                       moved["tp_to_dp"]) <= PAR_MOVE_TOL
               and min(moved["control_quarter_batch"],
                       moved["control_untrained"]) > PAR_MOVE_TOL
               and tp_rel <= 2e-3
               and max(pipe.values()) <= PAR_F32_TOL
               and max(experts["dense_rel_err"],
                       experts["a2a_rel_err"]) <= PAR_F32_TOL
               and experts["dropped_cf4"] == 0
               and experts["dropped_cf1"] == experts["dropped_cf1_expected"]
               and (not per_card or not any(staged)))
    return b


def main_four_cards(seed) -> int:
    """`--four-cards`: the build and phase 19 (b) alone, one rank a card
    over NCCL."""
    device = torch.device("cuda", 0)
    if torch.cuda.device_count() < PAR_RANKS:
        print(f"chip_smoke: --four-cards needs {PAR_RANKS} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    emit({"phase": "env", "nvidia_smi": nvidia_smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    res = par_ranks(device, seed, per_card=True)
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel_ranks", **res})
    if not res["ok"]:
        raise AssertionError(f"phase 19 (b) failed: {res}")
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the build and phase 19 (b), one rank on "
                    f"each of {PAR_RANKS} cards over NCCL")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.four_cards:
        return main_four_cards(args.seed)
    device = torch.device("cuda", 0)
    record = {}
    t_start = time.perf_counter()

    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(device)
    env = {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "capability": list(cap),
           "device": torch.cuda.get_device_name(device),
           "device_count": torch.cuda.device_count()}
    emit(env)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got "
                         f"{cap}")
    record["env"] = env

    t0 = time.perf_counter()
    _build.library()
    lib = _build.build()
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "library": str(lib.relative_to(_build.PACKAGE_DIR.parent)),
             "functions": kernel_functions(lib)}
    emit(build)
    record["build"] = build
    tc = {name: f for name, f in build["functions"].items()
          if name.startswith(TENSOR_CORE_KERNELS)}
    if (len(tc) != len(flash.KERNEL_HEAD_DIMS) * len(TENSOR_CORE_KERNELS)
            or any(f["hgmma"] + f["hmma"] == 0 or f["spill_bytes"]
                   for f in tc.values())):
        raise AssertionError(f"the bf16 K1/K2/K3 kernels must be built, "
                             f"hold HGMMA or HMMA and spill nothing: {tc}")
    pk = {name: f for name, f in build["functions"].items()
          if name.startswith(PAGED_KERNELS)}
    if (len(pk) != len(paged.KERNEL_HEAD_DIMS) * len(PAGED_KERNELS)
            * len(flash.KERNEL_DTYPES)
            or any(f["spill_bytes"] for f in pk.values())):
        raise AssertionError(f"K4's split and combine kernels must be "
                             f"built for both dtypes and head dims and "
                             f"spill nothing: {pk}")

    timer = Timer(device)
    cases, worst = phase_kernels(device, timer, args.seed)
    emit({"phase": "kernels", "cases": cases})
    record["kernels"] = cases

    parity = phase_parity(device, args.seed)
    emit({"phase": "parity", **parity})
    record["parity"] = parity
    if not parity["ok"]:
        raise AssertionError(f"parity failed: {parity}")

    serve, params, plens = phase_serve(device, args.seed)
    emit({"phase": "serve", **serve})
    record["serve"] = serve
    if not serve["ok"]:
        raise AssertionError(f"serve failed: {serve}")

    kernels, steps = main_path_timing(device, timer, params, plens, serve,
                                      args.seed, worst, serve["launches"])
    shared = {}  # what a later phase compares with an earlier one's
    for name, fn in (("serve_features",
                      lambda: phase_serve_features(device, args.seed,
                                                   params, timer)),
                     ("serve_features_parity",
                      lambda: phase_serve_features_parity(device,
                                                          args.seed)),
                     ("http_serve",
                      lambda: phase_http_serve(device, args.seed, params,
                                               timer)),
                     ("disagg",
                      lambda: phase_disagg(device, args.seed, params,
                                           timer, shared)),
                     ("fleet",
                      lambda: phase_fleet(device, args.seed, params,
                                          timer, shared))):
        t0 = time.perf_counter()
        res = fn()
        res["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **res})
        record[name] = res
        if not res["ok"]:
            raise AssertionError(f"{name} failed: {res}")
    del params

    train_parity = phase_train_parity(device, args.seed)
    emit({"phase": "train_parity", **train_parity})
    record["train_parity"] = train_parity
    if not train_parity["ok"]:
        raise AssertionError(f"train parity failed: {train_parity}")

    train, params, batches = phase_train(device, args.seed)
    emit({"phase": "train", **train})
    record["train"] = train
    if not train["ok"]:
        raise AssertionError(f"train failed: {train}")

    bwd_rows, steps["train"] = train_timing(device, timer, params, batches,
                                            args.seed, worst,
                                            train["launches"])
    del params, batches

    t0 = time.perf_counter()
    ml_parity = phase_multilayer_parity(device, args.seed)
    ml_parity["seconds"] = time.perf_counter() - t0
    emit({"phase": "multilayer_parity", **ml_parity})
    record["multilayer_parity"] = ml_parity
    if not ml_parity["ok"]:
        raise AssertionError(f"multilayer parity failed: {ml_parity}")

    t0 = time.perf_counter()
    ml_train = phase_multilayer_train(device, args.seed)
    ml_train["seconds"] = time.perf_counter() - t0
    emit({"phase": "multilayer_train", **ml_train})
    record["multilayer_train"] = ml_train
    if not ml_train["ok"]:
        raise AssertionError(f"multilayer training failed: {ml_train}")
    t0 = time.perf_counter()
    ml_shape = multilayer_kernel_timing(device, timer, args.seed)
    ml_train["kernel_timing_seconds"] = time.perf_counter() - t0

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    for name, fn in (("solver_parity", phase_solver_parity),
                     ("dbn", phase_dbn),
                     ("solver_attention", phase_solver_attention),
                     ("checkpoint", phase_checkpoint),
                     ("resume", phase_resume),
                     ("guardian", phase_guardian),
                     ("readers", phase_readers),
                     ("cli", phase_cli),
                     ("pipeline", phase_pipeline),
                     ("lstm", phase_lstm)):
        t0 = time.perf_counter()
        res = fn(device, args.seed)
        res["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **res})
        record[name] = res
        if not res["ok"]:
            raise AssertionError(f"{name} failed: {res}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    shutil.rmtree(CLI_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    par = phase_parallel(device, args.seed)
    par["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel", **par})
    record["parallel"] = par
    if not par["ok"]:
        raise AssertionError(f"parallel failed: {par}")
    t0 = time.perf_counter()
    ring_shape = ring_kernel_timing(device, timer, args.seed)
    par["kernel_timing_seconds"] = time.perf_counter() - t0

    for name, fn in (("nlp", phase_nlp), ("rntn", phase_rntn),
                     ("clusters", phase_clusters)):
        t0 = time.perf_counter()
        res = fn(device, args.seed, shared)
        res["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **res})
        record[name] = res
        if not res["ok"]:
            raise AssertionError(f"{name} failed: {res}")
        if name == "nlp":  # phase 22's host Barnes-Hut, beside phase 21
            shared["barnes_hut"] = start_barnes_hut(shared["config3c"],
                                                    args.seed)

    k1, k4 = kernels
    sf = record["serve_features"]["launches_by_path"]
    k1["draft_shape"] = \
        record["serve_features"]["speculation"]["model"]["draft_k1_check"]
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["draft_shape"]["max_abs_err"])
    http = {name: record[name]["launches"] if name == "disagg"
            else record[name]["generate"]["launches"]
            for name in ("http_serve", "disagg")}
    fleet_launches = record["fleet"]["launches"]
    k1["launches_by_path"] = {"serve": k1["launches"],
                              **sf["flash_fwd"],
                              "http": http["http_serve"]["flash_fwd"],
                              "disagg": http["disagg"]["flash_fwd"],
                              "fleet": fleet_launches["flash_fwd"],
                              "train": train["launches"]["flash_fwd"]}
    k4["launches_by_path"] = {"serve": k4["launches"], **sf["paged_decode"],
                              "http": http["http_serve"]["paged_decode"],
                              "disagg": http["disagg"]["paged_decode"],
                              "fleet": fleet_launches["paged_decode"]}
    k4["launches"] = sum(k4["launches_by_path"].values())
    for row in bwd_rows:
        row["launches_by_path"] = {"train": row["launches"]}
    for row in (k1, *bwd_rows):
        row["launches_by_path"]["multilayer"] = \
            ml_train["launches"][row["name"]]
        row["launches_by_path"]["solver"] = \
            record["solver_attention"]["launches"][row["name"]]
        row["launches_by_path"]["guardian"] = \
            record["guardian"]["launches"][row["name"]]
        row["launches_by_path"]["cli"] = \
            record["cli"]["launches"][row["name"]]
        row["launches_by_path"]["pipeline"] = \
            record["pipeline"]["launches"][row["name"]]
        row["launches_by_path"]["parallel"] = \
            par["attention"]["launches"][row["name"]]
        row["launches_by_path"]["ring"] = sum(
            par["ranks"]["ring"][m]["launches"][row["name"]]
            for m in ("causal", "not_causal"))
        row["launches"] = sum(row["launches_by_path"].values())
        row["multilayer_shape"] = ml_shape[row["name"]]
        row["ring_shape"] = ring_shape[row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 ml_shape[row["name"]]["max_abs_err"],
                                 *(r["max_abs_err"] for r in
                                   ring_shape[row["name"]].values()))
    for row in (k1, *bwd_rows, k4):  # 0: these paths have none
        for path in ("nlp", "rntn", "clusters"):
            row["launches_by_path"][path] = \
                record[path]["k1_k4_launches"][row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
    kernels = [k1, *bwd_rows, k4]
    emit({"phase": "main_path_steps", **steps})
    record["main_path_steps"] = steps
    record["kernels_summary"] = kernels
    smi_after = nvidia_smi()
    record["nvidia_smi"] = smi_after
    record["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(smi_after, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
