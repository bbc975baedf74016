#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:
 1. device  — require CUDA, print the card's name and power limit, set
              and print the TF32 flags;
 2. build   — compile the port's CUDA kernels from csrc/ and time it;
 3. kernels — hold every kernel of the serving, training and kernel-tier
              paths against its plain PyTorch version on the card, in f32
              and bf16, at the shapes its path gives it (and for softmax
              and RMSNorm forward every route of their plans at N in {1,
              2, 10, 33, 300, 1000, 1024, 30522, 70000} x R in {1, 8, 16,
              128, 4095}; for LayerNorm forward every route at N in {1,
              2, 33, 300, 1000, 1024, 2048, 2049, 58080}, for LayerNorm
              backward at N in {1, 2, 33, 300, 1000, 1024, 2048, 2049,
              14520, 14528} and for RMSNorm backward at N in {1, 2, 33,
              300, 1000, 1024, 2048, 2049, 14528}, each x R in {1, 7, 8,
              9, 4095}, with and without the affine weights, the warp
              routes at the path shape (4096, 1024) equal to the bit to
              their CPU emulations; for the reduction both routes at n in
              {0, 1,
              4096, 4097, 1000003, 2^26}, aligned and one element off,
              and at the route threshold; for the softmax backward every
              route at N in {1, 2, 10, 33, 512, 513, 1000, 1024, 30522,
              70000} x R in {1, 8, 16, 128, 4095} and N = 300000, for the
              scan both routes, forward and reverse, at 12 (rows, N) from
              (1, 1) to (1, 2^24), each equal to the bit to its route's
              emulation; two calls giving the same
              bits), and time kernel, plain version and one library call
              beside the least time the card could take (softmax at every
              path's shape, LayerNorm also at the training shape, the
              softmax backward and the scan at the kernel table's shapes
              of every route, the flash forward also causal at the
              serving shapes (1 and 8, 512, 16 x 64) beside SDPA with
              is_causal; the fused optimizer update at the flagship's
              195 weight shapes, Adam with bf16 and f32 moments, with and
              without weight decay, SGD plain, with momentum and nesterov,
              three updates each equal to the bit to the per-tensor loop,
              and on a ragged list of unaligned views); print
              ptxas's registers, spills and shared memory of the bf16
              tensor-core flash kernels, of the softmax, RMSNorm and
              LayerNorm forward kernels, the LayerNorm and RMSNorm
              backward kernels, the softmax backward and the reduction and
              scan kernels, and the decode, flash, softmax, RMSNorm,
              LayerNorm, reduce and cumsum calls per route (tc: bf16
              tensor cores, cc: CUDA cores; rows, block, cluster, loop;
              warp, block; cta, grid; row, split) with each decode row's
              plan (route, splits; a split call is a kernel and a combine
              launch);
 4. serve   — the full-width serve-bench LM (hidden 1024, 16 heads,
              12 layers, vocab 30522, window 512; random weights from a
              fixed generator, bf16 mixed precision) through the default
              ContinuousBatcher(num_slots=8, max_len=1024, page_size=16):
              the decode iteration and each slot's prefill chunk as CUDA
              graphs, the prefix cache on. 8 warm-up requests (one a
              slot: every graph captured), then the 16 requests earlier
              runs served (RandomState(0) after one warm-up prompt),
              prompts of 32-512 tokens, 32-64 new tokens each, timed; the
              timed run
              must only replay graphs (no warm-up, capture or eager
              walk); every request must finish with exactly its token
              count, every serving kernel must have launched (in the
              warm-up's walks and captures: a replay runs no wrapper and
              counts nothing; phase 16 holds a replay's device kernels
              against a walk's launches), every decode and
              multi-query call must have taken the tc route, every
              softmax (the LM head over 30522) the cluster route, and
              every LayerNorm forward the warp route;
 5. cross   — the first token's probabilities for two prompts on the card
              against the port on the CPU (plain versions), same weights,
              through the executor and read from the serve batcher's
              captured chunk graph;
 6. train   — bench.py's flagship BERT encoder at full width (batch 8,
              seq 512, hidden 1024, 16 heads, 12 layers, FFN 4096, vocab
              30522; bf16 mixed precision, Adam alpha 1e-4 with bf16
              moments) through FFModel.compile and fit on random tokens
              and labels from np.random.RandomState(0): warm-up steps,
              then timed steps; every loss finite, every training kernel
              launched its count per step (the 12 + 12 flash launches on
              the bf16 tensor-core route, the classifier's softmax forward
              and backward on the rows route, the 24 LayerNorm forward and
              24 backward
              launches on the warp route, the 2 reductions on the cta
              route), and the kernel
              registry (its auto policy) picked the kernels;
 7. train-witness — the train phase's first three steps again from the
              same weights and batch in f32 on the card and in f32 on the
              CPU: per-step losses against the CPU's, and the classifier's
              logit gap before and after the first step;
 8. train-cross — the loss and gradient norms of the first two steps
              (one Adam update with bf16 moments between them) of the
              same encoder cut to 2 layers, in f32, on the card against
              the port on the CPU, same weights and batch;
 9. tier    — the JAX package's kernel-tier graph (input (8, 512, 1024)
              -> layer_norm -> rms_norm -> dense(10) -> softmax, sparse CE
              and accuracy, SGD lr 0.05, data from RandomState(8)): 3 fit
              steps on the card in bf16 under kernel_impl="pallas" (each
              kernel's launches per step asserted, the softmax on the rows
              route, forward and backward, the RMSNorm and the LayerNorm
              forward and backward on the warp route, the reductions on
              the cta route) and under
              "reference"
              (no kernel launches), and on the CPU in f32 as a witness;
10. ref-vs-kernel — the flagship cut to 2 layers, f32, two Adam steps on
              the card under kernel_impl="pallas" and "reference" (flash
              against the einsum core, the CUDA norms against the
              reference lowerings): loss and six gradient norms.
11. standalone — the public entries no model path calls: head-separated
              flash attention in the bhld layout (forward and backward
              through its autograd Function, at the TP rank's shape),
              `fused_cumsum` (forward and its reversed-scan gradient) at
              (4096, 1024) on the scan's row route and one `cumsum` at
              (3, 1000003) on its split route; each kernel's launches and
              the scan's routes counted.
12. tp      — two ranks sharing cuda:0 (gloo, collectives staged through
              host memory) train the train phase's encoder, full width,
              under compile(parallel_axes={"model": 2}): 5 steps from the
              same weights and batch; every rank's loss the same bits at
              every step, the replicated weights the same bits at the
              end, per step and rank exactly 12 head-separated flash
              forward and backward launches (blhd, on the tensor-core
              route) and no packed one,
              the LayerNorm, softmax and reduction counts (and routes) of
              the train phase, and the first three losses within 2e-2 of
              the train
              phase's;
13. tp-cross — in the same ranks, the train-cross model (2 layers, f32,
              same weights and batch) under model=2: loss and the six
              whole-gradient norms of two steps against the train-cross
              phase's card run, within 1e-4.
14. train-graph — the train phase's flagship from the same initial
              weights and batch: 12 steps through
              fit(steps_per_execution=4) (a CUDA graph of 4 captured steps,
              replayed) against 12 eager steps, every loss and every final
              weight the same bits; launches counted from the warm-up
              dispatch and the capture (2 x 4 x a step's); host wall a
              step, device busy, idle share, launches a step and MFU for
              K = 1 eager and K = 4 graphed (tools/train_profile.py
              profile_fit), and peak memory of each run;
15. mlp     — the digits gate's MLP (64 -> 128 -> 64 -> 10, RELU, Adam
              2e-3, batch 64) on make_synthetic's seeded data, trained
              eagerly, with steps_per_execution=4, with accum_steps=2 and
              through attached (shuffled) dataloaders: eval accuracy > 0.9
              each, the K=4 run's losses those of the eager run, the eager
              run's launches per step asserted.
16. serve-graph — one decode iteration and one prefill chunk of the serve
              LM through the eager walk and through a graph replay, on
              the same caches and inputs: probabilities, picks and cache
              rows the same bits; launches of one walk of each; the
              profiler's device kernels of a replay those of a walk, and
              each serving kernel's count in a replay the walk's
              launches; the host wall of a dispatch each way;
17. generate — GenerativeSession on the serve LM (batch 8, window 512,
              max_len 1024): 8 prompts of one length from [32, 512], 64
              greedy tokens at tokens_per_dispatch 1 and 8 (a CUDA graph
              of K decode steps), the same tokens; ms a token; one-token
              calls for the prefill's host wall; the session's own
              launches only, 12 causal flash forwards on the tensor cores
              a generate call;
18. oneshot — the serve mix's first 8 requests under
              prefill_chunk_tokens=0: agreement with the serve phase's
              greedy tokens (reported), TTFT;
19. prefix  — make_shared_prefix_workload(16, 4, 128, 2, 8, 32, 64) with
              the prefix cache and without: hits and pages saved, the
              followers' tokens the cold run's bits, TTFT of hits and
              misses. Each of 16-19 must launch its path's kernels.
20. spec    — speculative decoding on the serve LM (tied and untied
              drafts, spec_tokens 3): replay == eager walk, launches of
              one walk, the f32 identities against plain greedy and the
              CPU.
21. resnet  — ResNet-50 (build_resnet50) at examples/python/native/
              resnet.py's widths (batch 16, 3x224x224, 10 classes), bf16,
              Adam with bf16 moments (tools/zoo_train.py): 12 eager fit
              steps, then 12 from the same weights through
              fit(steps_per_execution=4) (a CUDA graph of 4 steps);
              losses, weights and running statistics the same bits;
              softmax forward / backward, 2 reductions and one Adam
              launch a step; ms a step, samples/s, MFU (3 x the ops'
              FLOPs), peak memory, beside the card's name and power limit.
22. nmt     — the LSTM NMT at build_lstm_nmt's defaults (vocab 32000,
              embed 512, hidden 512, 2 layers; batch 32, seq 24 as
              nmt_lstm.py): the same pair; the (768, 32000) softmax's
              routes.
23. dlrm    — DLRM at DLRMConfig()'s defaults (four 1,000,000 x 64 f32
              tables, batch 64 as dlrm.py), bag size 1 and 8 (the SUM
              bags): 5 fit steps each.
24. dropout — the flagship BERT with attention dropout 0.1: the same
              pair through the einsum core (no flash launch in training),
              two replays at lr 0 with other losses (new masks), and
              inference through the flash kernel equal to a dropout-0
              model's to the bit.
    zoo     — AlexNet, the MNIST MLP and CNN, the CIFAR-10 CNN,
              ResNeXt-50, Inception-v3, XDL, CANDLE Uno, MLP_Unify,
              build_transformer, the `profile --model moe` MoE
              transformer and MoeConfig()'s encoder (the unfused
              group_by / aggregate path; head dim 4, so the einsum
              attention core) at their examples' widths: 3 fit steps
              each.
    zoo-witness — build_resnet(stages=(1, 1)) at 64 px and the NMT cut
              to 1 layer, 2 f32 Adam steps on the card and on the CPU
              from the same weights: losses within 1e-3.
25. moe-switch — the switch transformer the JAX package's MoE dry-run
              prices (256 experts, top-2, hidden 1024, 2 layers, vocab
              8192; batch 8 x 128 tokens), bf16, Adam: 12 eager steps
              and 12 through K = 4 (losses, weights and router state the
              same bits), launches and routes a step (the gates' (1024,
              256) softmax on "rows"), drops finite and equal; ms a step,
              samples/s, MFU over the port's FLOPs, peak memory, busy,
              idle.
26. moe-serve — the MoE serve-bench LM at the serve phase's widths (4
              experts, top-2, no drops) through the batcher with
              expert-affine admission on and off on the serve phase's 16
              requests: every request full length, only replays timed,
              picks > 0, on and off the same tokens, 0 router drops, the
              ff_moe_* and ff_serving_affinity_* families exposed; each
              run's launches those of its batcher's warm-up walks, a
              decode iteration's and a chunk's (MOE_SERVE_PER_WALK).
27. moe-witness — the switch transformer cut to 1 layer, 16 experts,
              hidden 128: 2 f32 Adam steps on the card and on the CPU,
              losses within 1e-3, drops equal.
28. predict — FFModel.predict at full width from seeded random weights:
              the flagship (bf16) on 35 samples at batch 8 (a tail of 3)
              and ResNet-50 (build_resnet50, batch 16, 224 px) on 69 (a
              tail of 5), and on ResNet-50's inputs its stem with a batch
              norm after two fit steps (no zoo builder has a batch norm);
              launches a batch asserted (flagship: 12 packed flash
              forwards on the tensor cores, 24 LayerNorm forwards, 1
              softmax forward; the others: 1 softmax forward; no
              backward kernel, no reduction, no update), f32 outputs of
              the right shape, finite, the same bits on a second call,
              the op state (the batch norm's running statistics) the same
              bits before and after; a witness (the flagship cut to 2 layers, f32, 11
              samples: the card against the port on the CPU, within 1e-3
              absolute); samples/s, and host wall against device busy a
              batch (tools/serve_profile.py trace_device);
29. manual  — the flagship (bf16, Adam with bf16 moments) from the train
              phase's initial weights and batch: 2 iterations of
              set_iteration_batch / forward / zero_gradients / backward /
              update against 2 eager fit steps, losses (the model's loss
              on forward's output) and final weights the same bits; then
              forward(seq_length=300) and backward(seq_length=300):
              finite gradients, 12 flash forwards (forward) and 12 + 12
              flash forwards and backwards (backward), all at l = 300 on
              the tensor cores;
30. checkpoint — the flagship cut to 2 layers (bf16, Adam bf16 moments)
              with tracing on: fit(steps_per_execution=4) for 4 steps
              (the graph captured), DurableCheckpointer.save (timed, its
              size), 4 steps (losses A), restore_latest (timed), 4 steps
              (losses B): A equal to B to the bit, replays and no new
              capture; a model from another seed restored from the file
              predicts the saved model's bits; the trace holds
              checkpoint.save, checkpoint.restore and one
              executor.multi_step a dispatch, the counters saved,
              verified and restored; then 2 requests through a
              ContinuousBatcher on the serve LM with trace_label="smoke":
              the exported Chrome trace holds serve.prefill and
              serve.decode spans on the thread named "smoke".
31. server  — InferenceServer over HTTP at full width: the flagship
              (bf16, 12 layers) registered with batch buckets (1, 4, 8),
              one CUDA graph each behind the DynamicBatcher, and the serve
              LM under register_continuous (a ContinuousBatcher with every
              graph captured first). Each bucket's first call (its eager
              warm-up and capture: PREDICT_PER_BATCH["flagship"] x 2 a
              bucket, on the tensor cores) while another thread keeps the
              batcher replaying (its tokens those of a direct submit);
              then 6 client threads POST 16 requests of 1-3 rows each to
              /v2/models/bert/infer while one POSTs /generate plain and
              "stream": true: every response within 5e-2 of
              InferenceModel.predict on its rows, the traffic only replays
              (no capture, no eager walk, no launch), the /generate tokens
              (and the stream's done trailer) those of the direct submit;
              a full bucket of 8 replayed equals the eager predict walk to
              the bit, with host wall, device busy and idle a call of each;
              /metrics (after one forced watchdog check, and a compile
              whose imported strategy names an op the graph lacks: one
              FFTA051 warning of the plan analysis) passes
              validate_exposition with the ff_inference_*, ff_serving_*,
              ff_kvpool_*, ff_checkpoint_*, ff_watchdog_* and
              ff_plan_diagnostics_total families, and stats() carries
              the analysis' counts under "_analysis";
              /healthz answers; the f32 witness: a 2-layer f32 flagship's
              buckets within 1e-4 of the same model on the CPU;
32. fold    — phase 28's ResNet-50 stem with a batch norm (batch 16,
              224 px, bf16, two fit steps) through an InferenceModel bucket
              of 16, before and after fold_batchnorm: the one batch norm
              folded, the outputs within 5e-2, launches of each capture
              (its warm-up and capture walks), the device kernels of a
              replay fewer after (the batch norm's eval walk gone), fit
              refused; then ResNet-50 through a bucket of 16 (pinned
              staging of its 9.6 MB input) against the eager predict walk
              of the same rows: the same bits, host wall, busy and idle a
              batch of each beside phase 28's.
33. cost    — the cost model and its calibration loop on the train phase's
              flagship (its weights): fit with profiling, 3 + 10 steps at
              K = 1, then 4 + 12 at K = 4 (StepStats: its MFU within 5%
              of the train phase's formula on the same steps); the
              Simulator over OpCostCache's measurements (CUDA events;
              hits, misses, failures); profile_ops (the five slowest
              ops); calibrate; refit against the K = 1 StepStats p50 (3
              rounds, tol 0.15: predicted, measured and ratio each round,
              converged or fail); the FittedProfile (h100-sxm / gpu)
              saved and reloaded through make_machine_model (the same
              prediction), the kernel registry's selections from its
              residual evidence; every weight, buffer and the generator
              the same bits after profile_ops and calibrate; a
              DriftDetector over 10 more steps (no breach); the
              task-graph dot written and parsed back (a node an op, an
              edge an edge); and the flash crossover sweep: the attention
              op (16 x 64, bf16) with use_flash True and False at b in
              {1, 8}, l in {16, ..., 512}, forward and forward + backward.
34. slots   — the serve LM through ContinuousBatcher(num_slots=None): the
              count derived from the H100 spec's 80 GB (clamped and not),
              16 warm-up requests (slots 0-15 and the decode graph
              captured), then the serve phase's 16 requests, timed (only
              replays): tokens/s, TTFT p50 / p99, ms a decode iteration,
              captures and replays, peak memory, beside the 8-slot run;
              the tokens equal to the bit to a batcher given the count
              explicitly; each request's first-token probabilities
              within 5% of the 8-slot run's peak; decode_attention at
              B = the derived count (M 1024, 16 x 64, positions from 0
              to 1023; bf16 and f32) against its plain version; one
              decode iteration of the derived batcher's graph (all its
              slots) against the one-slot chunk path over each prompt
              and its first token, within 5% of the peak; the f32
              witness (1 layer, hidden 64, num_slots=None) the CPU's
              tokens. Its decode ms is the timed run's own, beside the
              batcher's lifetime mean, whose warm-up captures the graph.
35. search  — four ranks sharing cuda:0 (gloo, host-staged) compile the
              train phase's encoder (full width and depth, bf16, Adam
              1e-4 with bf16 moments, seed 0) with no axes and
              search_budget > 0: rank 0 runs the Unity search on op costs
              measured on the card (OpCostCache, CUDA events) and
              broadcasts the plan, every rank adopts it (the mesh may be
              smaller than the world: a rank past it must refuse to fit),
              and the mesh's ranks fit 3 steps on the train phase's
              batch. Fails if the ranks' plans or losses differ, a loss
              is more than 2e-2 relative from the one-device train
              phase's, a flagship op's cost measurement failed, the plan
              analysis reported an error, or a rank past the mesh
              trained. Rank 0 also runs the analytic search of the same
              graph for h100-sxm x 4 twice: the second must be a
              plan-cache hit with the same plan. Prints the plan (axes,
              ops by (dp, tp), the ops below the data degree or above tp
              1), the predicted step, the search's wall, the cost cache's
              hits, misses and failures, the candidates simulated and
              pruned, the diagnostics by code, launches a step by kernel,
              and ms a step (four ranks time-sharing one card over gloo:
              not a mesh speed).

36-41. axes — four ranks sharing cuda:0 (gloo, host-staged), one spawn,
              one job a leg (tools/tp_train.py), bf16, Adam 1e-4 with
              bf16 moments, 3 fit steps (the last counted): seq-ring (the
              flagship encoder at full width, 2 of its 12 layers, batch 8,
              l 512, on {"seq": 4}: ring attention), seq-ulysses (the
              same, Ulysses: B1 at 4 heads a rank), expert (the switch
              transformer of phase 25 on {"expert": 4}), row (the flagship
              at 2 layers on {"data": 2, "model": 2} by an imported plan
              that makes each FFN a Megatron pair, fit(
              steps_per_execution=2), 4 steps), attr (ResNet-50 at 224,
              batch 16, on {"data": 2, "attr": 2}) and stage (the
              flagship's 12 layers as 4 stages, 4 microbatches). Fails if
              the ranks' losses or replicated weights differ, a loss is
              more than 2e-2 relative from the same model on one card
              (this process, after the spawn), or a leg's kernels did not
              launch (Ulysses' flash on the tensor cores). Prints each
              leg's launches a step by kernel and route, the staged bytes,
              peak memory and weights by rank, and ms a step (four ranks
              time-sharing one card: not a mesh speed). The kernels
              phase holds B1 at the Ulysses shape (8, 512, 4 x 64) too.
42. stage-checkpoint — in the same spawn, the stage leg saves a
              checkpoint (runtime/durability.py) and restores it into a
              fresh compile drawn from another seed: the file's keys are
              the JAX package's stacked `__pipeline__` layout (built here
              from the pipeline plan), and the restore gives the weights,
              Adam's moments and the predictions to the bit.
43. lowering — in the same spawn, the flagship at 2 layers in f32 on
              {"data": 4} with a two-tier 2 x 2 machine spec (A82_SPEC),
              3 SGD steps under collective_lowering="explicit" (the
              priced per-tier plan run as grouped collectives) and under
              "gspmd" (one flat bucket): the executed plan equals the
              priced plan with at least one entry decomposed, the losses
              agree within 1e-5 relative and each weight's update norm
              within 1e-3 (SGD's update scales with the synced gradient,
              so a sync off by a factor fails). In every leg of 43-45
              the ranks' replicated weights agree to the bit.
44. reshard — in the same spawn, the flagship (12 layers, bf16) after 2
              steps on {"data": 4}: its weights and Adam moments
              redistributed (resharding/, the FFTA06x gate on, 64 MiB of
              round scratch) onto a fresh compile on {"data": 2,
              "model": 2}, every leaf the gathered whole's slice to the
              bit, the observed round scratch within the planned, 2 more
              steps there; then moved back onto {"data": 4}, checked the
              same way.
45. taso    — in the same spawn, the flagship at 2 layers with its tokens
              repartitioned and combined (explicit parallel ops) compiled
              with no axes under the analytic search and
              substitutions/graph_subst_3_v2.json: the plan holds a
              parallel op, and 2 steps are finite, rank-identical and
              within 2e-2 of one card. The search applies no rewrite:
              graph_subst_3_v2.json's GraphXfers match no op of the
              encoder (as in the JAX package). So a second leg
              (taso-replay) compiles from a strategy file that records
              tp_rules.json's partition_linear_combine_d2 on layer0_ff1
              over {"data": 2, "model": 2}: compile applies the GraphXfer,
              the plan holds its Replicate and Combine, and 2 steps are
              rank-identical and within 2e-2 of one card.
46. collective-sweep — in the same spawn, obs/collective_bench.py's
              sweep over flat, rs_ar_ag and hier_ring at 0.25-4 MB and
              each tier's ring phase, on the four ranks as one data axis
              of A82_SPEC: every row positive, and
              fit_collective_coefficients gives a scale per tier. Its
              times are rank 0's CUDA events of host-staged gloo
              collectives: not a mesh speed.
47. mesh-session-f32 — in the same spawn, the serve LM at its full widths
              (hidden 1024, 16 heads, vocab 30522, window 512) cut to 2 of
              its 12 layers, f32, compiled in inference mode on {"data":
              2, "model": 2}: a GenerativeSession of 4 prompts (64 tokens)
              and 32 greedy tokens (max_len 1024), each rank prefilling
              and decoding its 2 rows over its 8 heads. Fails unless every
              rank returns the same tokens, equal to the same session on
              one card (this process, the same weights).
48. mesh-session — the same at bf16 and full depth (12 layers): every
              rank the same tokens; the prefill's last-position
              probabilities within 5e-2 of max(p) of one card's; the
              tokens that agree with one card's counted; rank 0's
              launches of one prefill (12 causal flash_fwd_blhd, 24
              layernorm_fwd, 1 softmax_fwd) and of one decode step (12
              decode_attention on the tensor cores, 24 layernorm_fwd, 1
              softmax_fwd) exactly.
49. mesh-infer — the flagship encoder (full width and depth, bf16) in an
              InferenceModel with buckets (1, 4, 8) on the same mesh: the
              buckets walk eagerly (no capture; graph_capture's reason
              printed), the 8-row output within 5e-2 of the one-card
              bucket graph's, a walk's launches on rank 0 (12
              flash_fwd_blhd, 24 layernorm_fwd, 1 softmax_fwd), and 8
              single-row requests through the leader-driven DynamicBatcher
              (one batch) equal to the direct predict within 1e-6, the
              followers walking the leader's batches.
50. resize  — on one card, the serve LM at full width and depth in f32
              (bf16 probabilities tie at the vocabulary's top, and 4 slots
              run other GEMM shapes than 8) in a ContinuousBatcher of 8
              slots: 6 requests with staggered budgets, shrunk to 4 slots
              and grown back to 8 while they decode. Fails unless every
              request's tokens equal an unresized run's, none is dropped,
              both resizes migrated live rows and captured the graphs
              again; prints each migration's priced us and moved bytes.
              The kernels phase holds B7 causal at the mesh's local shape
              (4, 512, 8 x 64, blhd) and B5 at 8 heads (the session's 2
              rows a rank) against their plain versions and SDPA.

51. elastic-live — the elastic coordinator (flexflow_tpu_torch/elastic/)
              on four ranks sharing the card over gloo, in a spawn of
              their own (tools/tp_train.py `elastic` jobs): the flagship
              encoder at full width (batch 8, seq 512, hidden 1024, 16
              heads, vocab 30522) cut to 2 of its 12 layers, f32, SGD,
              the analytic search (search_budget 4). A transient at step
              1 and the loss of ranks 2 and 3 at step 3, over 8 steps:
              the retry absorbs the transient, the re-plan runs on 2
              ranks, the restore is live (no checkpoint file read on any
              survivor: the ff_checkpoint_* restored / verified / corrupt
              counters do not move) and resumes at step 3, every step
              commits once, the survivors' losses equal each other to the
              bit and lie within 1e-4 relative of an uninterrupted run of
              the same weights and data on all four ranks (the next job:
              ranks 2 and 3, which left at step 3, came back). Prints the
              reshard's bytes moved, rounds and wall, and rank 0's
              launches of the first step after the recovery.
52. elastic-disk — in the same spawn: the live tree poisoned and ranks 0
              and 1 lost at step 3: recovery.live_fallback (reason
              verify), a disk restore of the step-2 checkpoint and its
              replay, rank 2 leading the search and writing the
              checkpoints after the loss; then a torn newest checkpoint
              and the loss of ranks 2 and 3 at step 4 with live
              resharding off: checkpoint.corrupt, then checkpoint.fallback
              to step 2's verified checkpoint.
53. elastic-nan — one card, the flagship at full depth (12 layers), bf16,
              Adam with bf16 moments: NaN steps 3-6, checkpoints every 2
              steps, 10 steps: 3 skips and one rollback to step 2 in the
              JAX package's event order, each skip leaving the weights,
              the optimizer state and the step count bit-identical, every
              loss finite; prints the rollback's restore wall and the
              checkpoint bytes.
54. elastic-drill — `python -m flexflow_tpu_torch.elastic.drill
              --scenario live-reshard --devices 4` on ranks sharing the
              card: it exits 0; its JSON line is printed.

55. fleet   — two replicas of 8 slots (max_len 1024, page 16) sharing
              the serve LM's weights behind the fleet Router: the
              shared-prefix mix (48 requests, 9 tenants of 256 tokens)
              under "affine" and "round_robin" (bf16), then an f32 copy
              through a peak -> trough -> peak swing with the Autoscaler
              live (8 -> 16 -> 4 slots) and one replica drained mid-burst.
              Fails unless no request is dropped, every greedy token list
              equals one ContinuousBatcher's on the same prompts, a grow
              and a shrink applied, a replica drained, the merged
              exposition validates with `replica` on ff_serving_ttft_ms
              and ff_kvpool_pages_used, and one replica's decode
              iteration and prefill chunk launch what FLEET_PER_WALK
              says. Prints tokens/s and TTFT p50 / p99 of each policy.
56. chaos   — the f32 copy through the chaos drill: a crash 12 tokens
              after arming on the replica homing the most tenants,
              under a live HealthMonitor (suspect 2 s, dead 10 s, polled
              every 0.1 s) and an Autoscaler that respawns it, traced
              with a flight recorder armed. Fails unless no request is
              dropped, every token list equals the undisturbed batcher's,
              every failed-over request's spans share its trace id, a
              bundle is written and DEAD lands inside the dead window;
              prints the time to DEAD.
57. disagg  — 12 prefill-heavy requests (384-512 tokens, the first 512)
              through ["unified", "unified"] and ["prefill", "decode"]
              (bf16), the handoffs priced on
              examples/machines/multipod_2x8.json. Fails unless the
              tokens are equal, nothing is dropped, and every committed
              handoff is priced, ships 49,152 B a prompt token and at
              most 64 MB a chunk; prints the handoffs' bytes, export and
              import ms, priced us and both layouts' ITL p99.
58. fleet-server — two one-shot replicas (the causal flash prefill)
              registered on the HTTP server: /generate plain and NDJSON
              and after a replica's loss equal to one batcher's tokens,
              /metrics validates with the `replica` label, /healthz ok
              and then degraded with the lost replica named.

59. onnx    — two graphs written with the port's wire.make_model,
              initializers N(0, 0.02) from a seed: the zoo's mnist_mlp
              (784 -> 512 -> 512 -> 10, Gemm + Relu, Softmax, batch 64)
              and a 2-layer attention stack at the flagship widths
              (hidden 1024, 16 heads of 64, FFN 4096 with Gelu, seq 512,
              batch 8; MatMul, Add, Reshape, Transpose, Div, Softmax,
              Gelu, residual Adds). Each imported with ONNXModel into
              the port, compiled, every initializer transferred (equal to
              the bit) and predicted in f32 (within 1e-4 of numpy's
              evaluation of the same graph, Gelu the importer's tanh
              form) and bf16 (max |err| within 2e-2 of max |ref|); prints
              predict ms of each.
60. fx      — a plain nn.Module encoder at the flagship widths
              (Embedding(30522, 1024), a learned position table read
              through get_attr, 12 blocks of MultiheadAttention(1024, 16)
              + residual + LayerNorm and Linear(1024, 4096), F.gelu,
              Linear(4096, 1024) + residual + LayerNorm, a Linear(1024, 2)
              head with softmax; seq 512, batch 8) traced with
              PyTorchModel: f32 predict within atol 1e-3, rtol 1e-3 of the
              module's own forward (f32 on the card, then freed), bf16
              within 5e-2; 3 SGD steps of fit with finite losses; the .ff
              file written by torch_to_flexflow reloads into the same
              ops. Launches of a bf16 predict walk and a fit step exactly
              (flash on the tensor cores).
61. cspec   — a flexflow_tpu_c_model spec of the same mnist_mlp through
              model_from_spec (f32): predict equal to the port's
              build_mnist_mlp given the same weights (load_params), and 3
              SGD steps' losses within 1e-5; the trained weights
              checkpointed for 62.
62. repository — one directory on the HTTP server: 59's two ONNX entries
              (the attention stack with "mixed_precision": false), 61's
              spec with its checkpoint and a broken entry (load goes on,
              ff_model_load_failures_total counts it); beside them the
              serve LM (bf16; 8 slots, max_len 1024, page 16) as a
              2-replica fleet entry with a speculative 2-layer draft and
              a disaggregated entry (one-shot prefill, priced on
              examples/machines/multipod_2x8.json). /infer equal to each
              entry's predict; the fleet's and the disagg entry's greedy
              tokens equal to one ContinuousBatcher's of the same
              geometry; every handoff priced; after unload /healthz and
              /metrics valid. One speculative iteration of the fleet
              entry's own replica launches what _spec_per_walk counts.
              Prints each entry's /infer ms and the fleet's tokens/s.
63. keras   — the Keras frontend (flexflow_tpu_torch.keras) at the
              examples' widths on keras.datasets' synthetic data:
              seq_mnist_mlp.py's Sequential 784-512-512-10 (Adam 1e-3,
              batch 64, 4 epochs over 6,000 samples) clears the
              example's 90% gate at the port's default bf16 (the softmax
              kernels) and in f32; under steps_per_execution=4: one
              CUDA graph captured for all 4 epochs' fit calls, every
              epoch's loss within 1e-6 relative of K = 1;
              func_cifar10_cnn.py's functional CNN (3x32x32, conv
              32/32/64/64, two max-pools, dense 512 and 10) for 20 steps
              (the example: 2 epochs of 50,000); the step losses on the
              card within 1e-3 in f32 and 2e-2 in bf16 of the port's CPU
              run of the same steps in the same precision (the MLP's
              first 40 in f32 and 20 in bf16, the CNN's first 8), and
              the MLP's first 40 bf16 within 2e-2 of the card's
              reference lowering (no kernel of the port; it parts from
              the CPU past ~26 steps as the kernels' run does); exactly
              the launches of one fit step (softmax forward and
              backward, the reduce twice, the fused Adam) and one
              predict walk (softmax forward) of each, and nothing else
              of the table; a Sequential with
              LayerNormalization: the LayerNorm kernels through Keras,
              its launches over its 10 steps and a predict exactly;
              keras_exp's Model over 59's ONNX mnist_mlp: build,
              compile, predict against numpy, fit, predict.
64. elastic-dead-peer — two ranks over gloo sharing the card: an
              all-reduce rank 1 never joins times out on rank 0 (gloo's
              text classifies transient), the failure detector's retry
              on the same group fails at once (gloo closed the pair:
              topology) and is escalated as TopologyLoss; then under the
              elastic coordinator rank 1 exits inside its step-2
              all-reduce: rank 0's failure classifies topology and the
              coordinator raises RecoveryFailed with the
              restart-from-checkpoint hint, within the spawn's time
              limit.
65. cli     — the command line, `flexflow_tpu_torch.__main__.main(argv)`
              in this process (each exit code read from its SystemExit,
              any but 0 fails): `serve-bench` at the flagship serving
              widths (hidden 1024, 16 heads, 12 layers, vocab 30522,
              8 slots, pages of 16, prompts 64-448, outputs 16-64, 16
              requests, max_len 512; f32, as the bench builds it) with
              the lockstep baseline: every requested token emitted, the
              continuous run launching the decode, multi-query decode,
              LayerNorm and softmax kernels and the lockstep run the
              flash forward; `profile --model bert -b 8` at the full
              widths (mixed precision, SGD): ok, its BENCH point, and
              the launches of one fit step equal to the flagship's step
              with SGD's one update (calibrate's own launches reported
              apart); `analyze` of examples/strategies/bert_8dev.json on
              8 chips, in process and through `python -m
              flexflow_tpu_torch`; `timeline` over the profile's trace,
              its merged file passing validate_trace.

Prints one JSON line per phase, then the kernel table
({"kernels": [...]}), the card's name and power limit, and last
{"ok": true, "device": {...}}. Exits 2 without printing a result when no
CUDA device is visible.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TC f32

# bench.py's flagship training configuration
TRAIN = dict(batch=8, seq=512, hidden=1024, heads=16, layers=12,
             vocab=30522)
SERVE_KERNELS = ("decode_attention", "multiquery_decode_attention",
                 "layernorm_fwd", "softmax_fwd")
# the kernels each serving phase of 16-19 must launch: the session and the
# one-shot batcher prefill through the causal flash forward
PATH_KERNELS = {
    "serve-graph": SERVE_KERNELS,
    "generate": ("flash_fwd", "decode_attention", "layernorm_fwd",
                 "softmax_fwd"),
    "oneshot": ("flash_fwd", "decode_attention", "layernorm_fwd",
                "softmax_fwd"),
    "prefix": SERVE_KERNELS,
    "spec": SERVE_KERNELS,
}
# launches of one batcher walk of the 12-layer MoE serve LM (phase 26):
# a layer's attention, its two LayerNorms and its gate's softmax, and the
# final softmax; a decode iteration runs the decode kernel, a prefill
# chunk the multi-query one
MOE_SERVE_PER_WALK = {
    "decode": {"decode_attention": 12, "layernorm_fwd": 24,
               "softmax_fwd": 13},
    "chunk": {"multiquery_decode_attention": 12, "layernorm_fwd": 24,
              "softmax_fwd": 13},
}
# speculative decoding's draft tokens an iteration (phase 20)
SPEC_TOKENS = 3
# launches per training step of the full-width flagship (12 layers)
TRAIN_PER_STEP = {"flash_fwd": 12, "flash_bwd": 12, "layernorm_fwd": 24,
                  "layernorm_bwd": 24, "softmax_fwd": 1, "softmax_bwd": 1,
                  "reduce": 2, "optimizer_adam": 1}
TRAIN_KERNELS = tuple(TRAIN_PER_STEP)
# the same launches by route: the flash kernels in bf16, so all on the
# tensor cores; the classifier's (4096, 2) softmax, forward and backward,
# on the "rows" route;
# the (4096, 1024) LayerNorm forward and backward on "warp"; the loss's
# and the accuracy's 4096-element means on "cta" (one launch each)
TRAIN_ROUTES_PER_STEP = {"flash_fwd/tc": 12, "flash_bwd/tc": 12,
                         "flash_fwd/cc": 0, "flash_bwd/cc": 0,
                         "softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                         "layernorm_fwd/warp": 24, "layernorm_bwd/warp": 24,
                         "reduce/cta": 2}
# launches per step of the kernel-tier graph under kernel_impl="pallas"
TIER_PER_STEP = {"layernorm_fwd": 1, "layernorm_bwd": 1, "rmsnorm_fwd": 1,
                 "rmsnorm_bwd": 1, "softmax_fwd": 1, "softmax_bwd": 1,
                 "reduce": 2, "optimizer_sgd": 1}
# the tier's (4096, 10) softmax, forward and backward, takes "rows", its
# (4096, 1024) RMSNorm
# and LayerNorm, forward and backward, "warp", its two 4096-element means
# "cta"
TIER_ROUTES_PER_STEP = {"softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                        "rmsnorm_fwd/warp": 1,
                        "rmsnorm_bwd/warp": 1, "layernorm_fwd/warp": 1,
                        "layernorm_bwd/warp": 1, "reduce/cta": 2}
TIER_KERNELS = tuple(TIER_PER_STEP)
# families the registry must pick the kernel for on the training path
# (the optimizer update is a family of the port's own)
TRAIN_FAMILIES = ("attention", "layernorm", "softmax", "reduction",
                  "optimizer")
# launches per step and rank of the full-width flagship under model=2:
# the head-separated flash kernels in place of the packed ones
TP_PER_STEP = {"flash_fwd_blhd": 12, "flash_bwd_blhd": 12, "flash_fwd": 0,
               "flash_bwd": 0, "layernorm_fwd": 24, "layernorm_bwd": 24,
               "softmax_fwd": 1, "softmax_bwd": 1, "reduce": 2,
               "optimizer_adam": 1}
TP_ROUTES_PER_STEP = {"flash_fwd_blhd/tc": 12, "flash_bwd_blhd/tc": 12,
                      "flash_fwd_blhd/cc": 0, "flash_bwd_blhd/cc": 0,
                      "softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                      "layernorm_fwd/warp": 24, "layernorm_bwd/warp": 24,
                      "reduce/cta": 2}
TP_KERNELS = ("flash_fwd_blhd", "flash_bwd_blhd")
# launches of the standalone entries (phase 11): fused_cumsum forward and
# backward at (4096, 1024) on "row", one cumsum at (3, 1000003) on "split"
# (its two launches counted once)
STANDALONE_LAUNCHES = {"flash_fwd_bhld": 1, "flash_bwd_bhld": 1,
                       "cumsum": 3, "cumsum/row": 2, "cumsum/split": 1}
STANDALONE_KERNELS = ("flash_fwd_bhld", "flash_bwd_bhld", "cumsum")
# the train-graph phase: fit(steps_per_execution=GRAPH_K) for GRAPH_STEPS
# steps against as many eager steps
GRAPH_K, GRAPH_STEPS = 4, 12
# launches per step of the mlp phase's MLP (64 -> 128 -> 64 -> 10, batch
# 64): the (64, 10) softmax, forward and backward, the means of the loss,
# the accuracy and the sparse cce metric, one Adam update
MLP_PER_STEP = {"softmax_fwd": 1, "softmax_bwd": 1, "reduce": 3,
                "optimizer_adam": 1}
# phase 28: predict's samples and batch, and its launches a batch (every
# other kernel none); the flagship's on the tensor-core route
PREDICT_RUNS = {"flagship": (35, 8), "resnet50": (69, 16)}
PREDICT_PER_BATCH = {
    "flagship": {"flash_fwd": 12, "flash_fwd/tc": 12, "layernorm_fwd": 24,
                 "softmax_fwd": 1},
    "resnet50": {"softmax_fwd": 1},
    # ResNet-50's stem with a batch norm, on ResNet-50's inputs
    "bn_stem": {"softmax_fwd": 1},
}
# phase 33: the crossover sweep's sequence lengths and rounds
# decode attention against its plain version: |err| <= a + r * |plain|
DECODE_TOL = {"bfloat16": (4e-3, 2e-2), "float32": (1e-5, 1e-4)}
CROSSOVER_LENGTHS = (16, 32, 64, 128, 256, 512)
CROSSOVER_ROUNDS = 5
# phase 29: the truncated iteration's length, and the flash launches of
# its forward and of its backward
MANUAL_SEQ = 300
MANUAL_FORWARD = {"flash_fwd": 12, "flash_fwd/tc": 12, "flash_bwd": 0}
MANUAL_BACKWARD = {"flash_fwd": 12, "flash_fwd/tc": 12, "flash_bwd": 12,
                   "flash_bwd/tc": 12}


def train_step_flops(batch, seq, hidden, layers, **_) -> float:
    """bench.py `train_step_flops` times the batch: 6 x matmul parameters
    x tokens plus the attention score and context products; the
    embedding gather is not counted."""
    params = layers * (2 * hidden * 4 * hidden + 4 * hidden * hidden)
    per_sample = 6.0 * params * seq + layers * 6.0 * 2.0 * seq * seq * hidden
    return per_sample * batch


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters=20, flush=None):
    """Mean device ms of fn() over `iters` calls after a warm-up, each call
    between its own pair of CUDA events; `flush` runs between calls
    (outside the timed window) where the real caller finds L2 cold.

    The host queues every call while the device spins in a long sleep
    kernel, so the events time device work only, not the host's Python
    and launch overhead between two calls (a small kernel runs in less
    time than its wrapper takes to launch it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(4):
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for _ in range(iters):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        ran_dry = slept.query()  # the sleep ended before the host finished
        torch.cuda.synchronize()
        if not ran_dry:
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 4
    raise RuntimeError("could not queue the timed calls ahead of the device")


def _span_ms(torch, fn, iters=3):
    """Device ms from an event before `iters` back-to-back calls of fn()
    to one after them, over `iters`, after a warm-up: for a function of
    thousands of launches, whose host issue rate bounds it, and which
    cannot be queued ahead of the device as _time_ms does."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, F):
    """Each kernel against its plain version at the serving shapes; returns
    {kernel name: table row} (launches filled in after the serve phase)."""
    from flexflow_tpu_torch.kernels import decode, norm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    B, M, H, D = 8, 1024, 16, 64
    scale = 1.0 / D ** 0.5
    # ragged positions, from a nearly empty slot to a full one
    pos8 = torch.tensor([0, 37, 255, 511, 700, 880, 1000, 1023 - 16],
                        dtype=torch.int32, device=dev)

    def decode_case(name, b, c, pos, dtype, tol):
        q = torch.randn((b, c, H, D), generator=g, device=dev).to(dtype)
        kc = torch.randn((b, M, H, D), generator=g, device=dev).to(dtype)
        vc = torch.randn((b, M, H, D), generator=g, device=dev).to(dtype)
        fn = getattr(decode, name)
        plan = decode.decode_plan(b, c, M, H, D, 512, dtype, dtype)
        out = fn(q, kc, vc, pos, scale=scale, block_k=512)
        ref = decode.decode_attention_plain(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol[0] + tol[1] * ref.float().abs()).all())
        row = {"shape": f"B={b} C={c} M={M} h={H} d={D} {dtype}".replace(
            "torch.", ""), "max_abs_err": float(err.max()),
            "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|",
            "plan": {"route": plan.route, "splits": plan.splits,
                     "split_rows": plan.split_rows, "single": plan.single,
                     "launches_per_call": plan.launches}}
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
        if dtype != torch.bfloat16:
            return row
        # timing: the cache is cold on the serving path (12 layers' caches
        # stream through between two launches of one layer)
        esz = kc.element_size()
        rows = (pos.long() + c).clamp(max=M)
        attended = sum(min(int(p) + j + 1, M) for p in pos.tolist()
                       for j in range(c))
        nbytes = (2 * int(rows.sum()) * H * D * esz + 2 * q.numel() * esz
                  + pos.numel() * 4)
        ops = 4 * H * D * attended
        bound, by = _bound(nbytes, ops, "bfloat16")
        qpos = pos.long()[:, None] + torch.arange(c, device=dev)[None, :]
        mask = (torch.arange(M, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]          # (B, 1, C, M)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
        row.update(
            ms=_time_ms(torch, lambda: fn(q, kc, vc, pos, scale=scale,
                                          block_k=512), flush=flush),
            plain_ms=_time_ms(torch, lambda: decode.decode_attention_plain(
                q, kc, vc, pos, scale), flush=flush),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
            bound_ms=bound, bound_by=by)
        return row

    bf16_tol, f32_tol = DECODE_TOL["bfloat16"], DECODE_TOL["float32"]
    table = {}
    for name, c, b, pos in (
            ("decode_attention", 1, B, pos8),
            ("multiquery_decode_attention", 16, B, pos8)):
        decode_case(name, b, c, pos, torch.float32, f32_tol)
        table[name] = decode_case(name, b, c, pos, torch.bfloat16, bf16_tol)
    # the serving path's chunk: one slot, 16 queries mid-prompt
    table["multiquery_decode_attention"]["serving_shape"] = decode_case(
        "multiquery_decode_attention", 1, 16,
        torch.tensor([480], dtype=torch.int32, device=dev), torch.bfloat16,
        bf16_tol)
    # speculative decoding's verify (spec_tokens 3): 8 slots of 4 queries
    # at ragged positions, the last slot at 1022 (two queries past the
    # cache's last row)
    verify_pos = torch.tensor([0, 37, 255, 511, 700, 880, 1000, 1022],
                              dtype=torch.int32, device=dev)
    decode_case("multiquery_decode_attention", B, 4, verify_pos,
                torch.float32, f32_tol)
    table["multiquery_decode_attention"]["verify_shape"] = decode_case(
        "multiquery_decode_attention", B, 4, verify_pos, torch.bfloat16,
        bf16_tol)

    def norm_case(name, rows, n, dtype, tol, timed):
        x = (torch.randn((rows, n), generator=g, device=dev) * 3 + 1).to(
            dtype)
        if name == "layernorm_fwd":
            gamma = torch.rand((n,), generator=g, device=dev) + 0.5
            beta = torch.randn((n,), generator=g, device=dev)
            out = norm.layernorm_fwd(x, gamma, beta)[0]
            ref = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)[0]
            run = lambda: norm.layernorm_fwd(x, gamma, beta)  # noqa: E731
            plain = lambda: norm.layernorm_fwd_plain(  # noqa: E731
                x, gamma, beta, 1e-5)
            g16, b16 = gamma.to(dtype), beta.to(dtype)
            lib = lambda: F.layer_norm(x, (n,), g16, b16, 1e-5)  # noqa: E731
            esz = x.element_size()
            nbytes = 2 * x.numel() * esz + 2 * n * 4 + 2 * rows * 4
            ops = 8 * x.numel()
        else:
            out = norm.softmax_fwd(x)
            if not torch.equal(norm.softmax_fwd(x), out):
                raise AssertionError(f"softmax_fwd: R={rows} N={n} {dtype} "
                                     "differs between two calls")
            ref = norm.softmax_fwd_plain(x)
            run = lambda: norm.softmax_fwd(x)  # noqa: E731
            plain = lambda: norm.softmax_fwd_plain(x)  # noqa: E731
            lib = lambda: torch.softmax(x, dim=-1)  # noqa: E731
            nbytes = 2 * x.numel() * x.element_size()
            ops = 5 * x.numel()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol[0] + tol[1] * ref.float().abs()).all())
        row = {"shape": f"R={rows} N={n} {dtype}".replace("torch.", ""),
               "max_abs_err": float(err.max()),
               "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|"}
        plan_of = (norm.softmax_plan if name == "softmax_fwd"
                   else norm.layernorm_fwd_plan)
        row["plan"] = plan_of(rows, n, dtype, torch.cuda.
                              get_device_properties(dev).
                              multi_processor_count)._asdict()
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
        if name == "layernorm_fwd" and rows == 4096:
            # the warp route's every step is rounded on its own: the CPU
            # emulation of its order gives the kernel's bits
            got = norm.layernorm_fwd(x, gamma, beta)
            emu = norm.layernorm_fwd_warp_plain(
                x.cpu(), gamma.cpu(), beta.cpu(), 1e-5, x.data_ptr() % 16)
            if row["plan"]["route"] != "warp" or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(got, emu)):
                raise AssertionError(f"layernorm_fwd at {row['shape']}: "
                                     f"{row['plan']}, or not the bits of "
                                     "layernorm_fwd_warp_plain")
            row["warp_plain_same_bits"] = True
        if timed:
            bound, by = _bound(nbytes, ops, "bfloat16" if dtype ==
                               torch.bfloat16 else "float32")
            # activations arrive hot in L2 from the op before: no flush
            row.update(ms=_time_ms(torch, run), plain_ms=_time_ms(
                torch, plain), library_ms=_time_ms(torch, lib),
                bound_ms=bound, bound_by=by)
        return row

    for name, n, tol in (("layernorm_fwd", 1024, (1e-2, 1e-2)),
                         ("softmax_fwd", 30522, (1e-6, 1e-2))):
        norm_case(name, 128, n, torch.float32, (1e-5, 1e-4), False)
        table[name] = norm_case(name, 8 * 16, n, torch.bfloat16, tol, True)
        # the serving path: 8 decode rows / 16 rows of a prefill chunk
        table[name]["serving_shape"] = norm_case(
            name, 8, n, torch.bfloat16, tol, True)
    # the other shapes the paths give them: LayerNorm's 24 launches a
    # training step; softmax over a prefill chunk's 16 rows, the training
    # step's classifier (4096, 2) and the tier's dense(10) (4096, 10)
    table["layernorm_fwd"]["training_shape"] = norm_case(
        "layernorm_fwd", 4096, 1024, torch.bfloat16, (1e-2, 1e-2), True)
    # the train-witness's f32 steps
    table["layernorm_fwd"]["training_shape_f32"] = norm_case(
        "layernorm_fwd", 4096, 1024, torch.float32, (1e-5, 1e-4), True)
    table["layernorm_fwd"]["ms_includes"] = "1 launch"
    # a training step's softmax runs the kernels in f32 on its bf16
    # logits (the autograd Function saves y in f32); inference in bf16
    table["softmax_fwd"]["path_shapes"] = {
        path: norm_case("softmax_fwd", rows, n, dtype,
                        (1e-6, 1e-2) if dtype == torch.bfloat16
                        else (1e-5, 1e-4), True)
        for path, rows, n, dtype in (
            ("prefill chunk", 16, 30522, torch.bfloat16),
            ("train step", 4096, 2, torch.float32),
            ("tier step", 4096, 10, torch.float32),
            ("NMT step", 768, 32000, torch.float32),
            ("ResNet step", 16, 10, torch.float32),
            ("DLRM step", 64, 2, torch.float32),
            ("MoE switch gate", 1024, 256, torch.float32),
            ("MoE serve gate decode", 8, 4, torch.bfloat16),
            ("MoE serve gate chunk", 16, 4, torch.bfloat16))}
    # a mesh session's decode rows on a rank of {"data": 2, "model": 2}
    # (phase 48): 2 rows of the hidden width and of the vocabulary
    for name, n, tol in (("layernorm_fwd", 1024, (1e-2, 1e-2)),
                         ("softmax_fwd", 30522, (1e-6, 1e-2))):
        table[name]["mesh_decode_shape"] = norm_case(
            name, 2, n, torch.bfloat16, tol, True)
    del flush_buf
    table.update(train_kernels(torch, F, g))
    table.update(tier_kernels(torch, F, g))
    table.update(heads_kernels(torch, F, g))
    table.update(cumsum_kernels(torch, g))
    table.update(optimizer_kernels(torch, g))
    ulysses_flash_kernels(torch, F, g, table)
    mesh_serve_kernels(torch, F, g, table)
    edges = norm_route_edges(torch, g)
    edges.update(bwd_route_edges(torch, g))
    for name in ("softmax_fwd", "rmsnorm_fwd", "layernorm_fwd",
                 "layernorm_bwd", "rmsnorm_bwd", "reduce", "softmax_bwd",
                 "cumsum"):
        table[name]["edges"] = edges[name]
    return table


def _flagship_weight_shapes():
    """The flagship's 195 weight shapes, from its graph (no weights
    drawn)."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import TransformerConfig, \
        build_bert_encoder

    m = FFModel(FFConfig(batch_size=TRAIN["batch"], device="cpu"))
    tok = m.create_tensor([TRAIN["batch"], TRAIN["seq"]], DataType.DT_INT32)
    build_bert_encoder(m, tok, TransformerConfig(
        num_layers=TRAIN["layers"]))
    return [ws.dims for op in m.ops for ws in op.specs]


def optimizer_kernels(torch, g):
    """The fused optimizer update (csrc/optimizer.cu) at the flagship's
    195 weight shapes: Adam with bf16 and with f32 moments, with and
    without weight decay; SGD plain, with momentum and nesterov (weight
    decay on nesterov). Three updates of each from zero state against the
    per-tensor loop on the card, every weight and moment the same bits
    (both round each operation on its own, in the same order); a ragged
    list (sizes 1, 7, 4097, 2^20 + 3, each view one element off, so no
    tensor takes the vector path) the same way. Timed: the kernel, the
    loop and the library: for Adam on f32 moments
    `torch.optim.Adam(fused=True)` (a landmark, not the same function:
    eps on the bias-corrected sqrt(v)), for SGD `torch.optim.SGD(
    fused=True)` (the same update);
    the bound is the bytes (each of w, g, m, v read once, w, m, v written
    once) over the HBM rate."""
    from flexflow_tpu_torch.kernels import optimizer as kopt

    import math

    dev = torch.device("cuda")
    shapes = _flagship_weight_shapes()
    n_el = sum(math.prod(d) for d in shapes)

    def state(moments, offset=0, sizes=None):
        def make(n, dtype, scale):
            buf = torch.randn((n + offset,), generator=g, device=dev)
            return (scale * buf).to(dtype)[offset:]
        dims = [(n,) for n in sizes] if sizes else shapes
        numel = [math.prod(d) for d in dims]
        ws = [make(n, torch.float32, 0.02).view(d) for n, d in
              zip(numel, dims)]
        gs = [make(n, torch.float32, 1e-3).view(d) for n, d in
              zip(numel, dims)]
        ms = [torch.zeros_like(w, dtype=moments) for w in ws]
        vs = [torch.zeros_like(w, dtype=moments) for w in ws]
        return ws, gs, ms, vs

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    rows = {}
    cases = [("optimizer_adam", "bf16 moments", torch.bfloat16, 0.0),
             ("optimizer_adam", "bf16 moments, wd 0.01", torch.bfloat16,
              0.01),
             ("optimizer_adam", "f32 moments", torch.float32, 0.0),
             ("optimizer_adam", "f32 moments, wd 0.01", torch.float32, 0.01),
             ("optimizer_sgd", "plain", None, 0.0),
             ("optimizer_sgd", "momentum 0.9", None, 0.0),
             ("optimizer_sgd", "nesterov 0.9, wd 0.01", None, 0.01)]
    for name, label, moments, wd in cases:
        for ragged in (False, True):
            ws, gs, ms, vs = state(moments or torch.float32,
                                   1 if ragged else 0,
                                   (1, 7, 4097, 2**20 + 3) if ragged
                                   else None)
            ref = [[t.clone() for t in ts] for ts in (ws, ms, vs)]
            step = torch.zeros((), dtype=torch.int32, device=dev)
            lr = torch.tensor(1e-4 if moments else 0.05, device=dev)
            mom = 0.0 if label == "plain" or moments else 0.9

            def run():
                if moments:
                    kopt.adam(ws, gs, ms, vs, step, lr, beta1=0.9,
                              beta2=0.999, eps=1e-8, weight_decay=wd)
                else:
                    kopt.sgd(ws, gs, ms, lr, momentum=mom,
                             nesterov="nesterov" in label, weight_decay=wd)

            def plain():
                if moments:
                    kopt.adam_plain(ref[0], gs, ref[1], ref[2], step, lr,
                                    0.9, 0.999, 1e-8, wd)
                else:
                    kopt.sgd_plain(ref[0], gs, ref[1], lr, mom,
                                   "nesterov" in label, wd)

            for _ in range(3):
                run()
                plain()
                step.add_(1)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in
                      zip(ws, ref[0]) if a.numel())
            if not (same(ws, ref[0]) and same(ms, ref[1])
                    and same(vs, ref[2])):
                raise AssertionError(f"{name} ({label}, ragged={ragged}) "
                                     "differs from the per-tensor loop after "
                                     f"3 updates (max |w err| {err})")
            if ragged:
                continue
            key = f"{name} {label}"
            row = {"shape": f"{len(shapes)} tensors, {n_el} elements, "
                            f"{label}", "max_abs_err": err,
                   "tolerance": "the same bits as the plain loop (w, m, v) "
                                "after 3 updates, and on a ragged list"}
            if wd == 0.0 or "nesterov" in label:
                msz = 0 if not moments else (2 if moments == torch.bfloat16
                                             else 4)
                has_v = 0 if label == "plain" else 1
                per = (12 + 4 * msz if moments
                       else 12 + 8 * has_v)
                bound, by = _bound(per * n_el, 20 * n_el, "float32")
                row.update(bytes_per_element=per, bound_ms=bound,
                           bound_by=by, ms=_time_ms(torch, run, iters=10),
                           plain_ms=_span_ms(torch, plain, iters=3),
                           plain_timing="events around 3 back-to-back "
                                        "calls: the loop's ~3,100 launches "
                                        "a call are not queued ahead")
                row["library_ms"] = None
                if moments != torch.bfloat16:
                    params = [torch.nn.Parameter(w.clone()) for w in ws]
                    for p_, g_ in zip(params, gs):
                        p_.grad = g_
                    if moments:
                        lib = torch.optim.Adam(params, lr=1e-4, fused=True)
                        row["library"] = ("torch.optim.Adam(fused=True), f32 "
                                          "moments: not the same function "
                                          "(eps on the bias-corrected "
                                          "sqrt(v))")
                    else:
                        lib = torch.optim.SGD(
                            params, lr=0.05, momentum=mom,
                            nesterov="nesterov" in label, weight_decay=wd,
                            fused=True)
                        row["library"] = ("torch.optim.SGD(fused=True): the "
                                          "same update (its buffer starts "
                                          "as g, = momentum * 0 + g)")
                    row["library_ms"] = _time_ms(torch, lib.step, iters=10)
                    del params, lib
            rows[key] = row
            del ws, gs, ms, vs, ref
            torch.cuda.empty_cache()
    table = {}
    for name, main in (("optimizer_adam", "optimizer_adam bf16 moments"),
                       ("optimizer_sgd", "optimizer_sgd momentum 0.9")):
        table[name] = dict(rows[main], cases={
            k: v for k, v in rows.items() if k.startswith(name)},
            ms_includes="1 launch (195 tensors)")
    return table


# the edge shapes every softmax_fwd and rmsnorm_fwd route is held at:
# N x R, f32 and bf16 (RMSNorm with and without gamma); N = 300000 is
# wider than a cluster of 8 holds (softmax's loop route)
NORM_EDGE_N = (1, 2, 10, 33, 300, 1000, 1024, 30522, 70000)
NORM_EDGE_R = (1, 8, 16, 128, 4095)
# the edge shapes of the LayerNorm forward and of the two warp-route
# backward kernels (LayerNorm, RMSNorm): N = 2049 the first of "block",
# 58080 the widest row the parent's LayerNorm forward took (N = 14520 the
# widest the LayerNorm backward's block route stages with gamma, 14528
# without); R = 7, 8, 9 about one CTA of 8 warps
LN_FWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 58080)
LN_EDGE_R = (1, 7, 8, 9, 4095)


def norm_route_edges(torch, g):
    """softmax_fwd, rmsnorm_fwd and layernorm_fwd against their plain
    versions at the edge shapes, every route of the three plans, at the
    tolerances of the path-shape checks; two calls give the same bits; an
    RMSNorm or LayerNorm row wider than a block's shared memory raises
    ValueError, where the parent refused it (RMSNorm) or its launch failed
    (LayerNorm). Also each cluster plan's cudaOccupancyMaxActiveClusters
    (at least 1). Returns {kernel: summary}."""
    from flexflow_tpu_torch.kernels import _build, norm

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-6, 1e-2)}
    rms_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    ln_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
    out = {k: {"checked": 0, "routes": {}, "max_abs_err": 0.0}
           for k in ("softmax_fwd", "rmsnorm_fwd", "layernorm_fwd")}

    def note(name, route, row):
        rec = out[name]
        rec["checked"] += 1
        rec["routes"][route] = rec["routes"].get(route, 0) + 1
        rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])

    shapes = [(r, n) for n in NORM_EDGE_N for r in NORM_EDGE_R]
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n in shapes + [(1, 300000), (3, 300000)]:
            x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(
                dtype)
            shape = f"R={rows} N={n} {dtype}".replace("torch.", "")
            plan = norm.softmax_plan(rows, n, dtype, sms)
            y = norm.softmax_fwd(x)
            note("softmax_fwd", plan.route, _agree(
                "softmax_fwd", y, norm.softmax_fwd_plain(x), sm_tol[dtype],
                shape))
            if not torch.equal(norm.softmax_fwd(x), y):
                raise AssertionError(f"softmax_fwd: {shape} differs between "
                                     "two calls")
            del x, y
        for rows, n in shapes:
            for affine in (True, False):
                x = (torch.randn((rows, n), generator=g, device=dev) * 2
                     + 1).to(dtype)
                gamma = (torch.rand((n,), generator=g, device=dev) + 0.5
                         if affine else None)
                shape = (f"R={rows} N={n} {dtype} "
                         f"{'affine' if affine else 'plain'}").replace(
                             "torch.", "")
                if n > norm.rmsnorm_max_n(dtype):
                    try:
                        norm.rmsnorm_fwd(x, gamma)
                    except ValueError:
                        out["rmsnorm_fwd"]["refused"] = shape
                        continue
                    raise AssertionError(f"rmsnorm_fwd took {shape}")
                plan = norm.rmsnorm_plan(rows, n, dtype, sms)
                y, rstd = norm.rmsnorm_fwd(x, gamma)
                ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
                note("rmsnorm_fwd", plan.route, _agree(
                    "rmsnorm_fwd", y, ry, rms_tol[dtype], shape))
                _agree("rmsnorm_fwd (rstd)", rstd, rrstd, rms_tol[
                    torch.float32], shape)
                y2, rstd2 = norm.rmsnorm_fwd(x, gamma)
                if not (torch.equal(y2, y) and torch.equal(rstd2, rstd)):
                    raise AssertionError(f"rmsnorm_fwd: {shape} differs "
                                         "between two calls")
                del x, y, y2
        ln_shapes = [(r, n) for n in LN_FWD_EDGE_N for r in LN_EDGE_R]
        for rows, n in ln_shapes + [(2, LN_FWD_EDGE_N[-1] + 1)]:
            for affine in (True, False):
                x = (torch.randn((rows, n), generator=g, device=dev) * 2
                     + 1).to(dtype)
                gamma = beta = None
                if affine:
                    gamma = torch.rand((n,), generator=g, device=dev) + 0.5
                    beta = torch.randn((n,), generator=g, device=dev)
                shape = (f"R={rows} N={n} {dtype} "
                         f"{'affine' if affine else 'plain'}").replace(
                             "torch.", "")
                if n > norm.layernorm_max_n(dtype):
                    try:
                        norm.layernorm_fwd(x, gamma, beta)
                    except ValueError:
                        out["layernorm_fwd"]["refused"] = shape
                        continue
                    raise AssertionError(f"layernorm_fwd took {shape}")
                plan = norm.layernorm_fwd_plan(rows, n, dtype, sms)
                got = norm.layernorm_fwd(x, gamma, beta)
                ry, rmean, rrstd = norm.layernorm_fwd_plain(x, gamma, beta,
                                                            1e-5)
                note("layernorm_fwd", plan.route, _agree(
                    "layernorm_fwd", got[0], ry, ln_tol[dtype], shape))
                for nm, a, b in (("mean", got[1], rmean),
                                 ("rstd", got[2], rrstd)):
                    _agree(f"layernorm_fwd ({nm})", a, b,
                           ln_tol[torch.float32], shape)
                again = norm.layernorm_fwd(x, gamma, beta)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    raise AssertionError(f"layernorm_fwd: {shape} differs "
                                         "between two calls")
                del x, got, again
    missing = [f"{k}/{r}" for k, routes in (
        ("softmax_fwd", norm.SOFTMAX_ROUTES),
        ("rmsnorm_fwd", norm.RMSNORM_ROUTES),
        ("layernorm_fwd", norm.LN_FWD_ROUTES)) for r in routes
        if r not in out[k]["routes"]]
    if missing:
        raise AssertionError(f"routes never held at the edges: {missing}")
    lib = _build.library()
    clusters = {}
    for rows, n in ((8, 30522), (16, 30522), (1, 70000), (4095, 70000)):
        for dtype in (torch.float32, torch.bfloat16):
            plan = norm.softmax_plan(rows, n, dtype, sms)
            fit = lib.ff_softmax_max_active_clusters(
                plan.threads, plan.per_thread, plan.cluster,
                _build.DTYPE_CODES[dtype])
            key = (f"R={rows} N={n} {dtype}: {plan.cluster} x "
                   f"{plan.threads}").replace("torch.", "")
            clusters[key] = fit
            if fit < 1:
                raise AssertionError(f"softmax_fwd cluster plan {key} does "
                                     f"not fit on the card ({fit})")
    out["softmax_fwd"]["max_active_clusters"] = clusters
    for rec in out.values():
        rec["tolerance"] = "the path shapes' (f32 and bf16)"
        rec["same_bits_on_two_calls"] = True
    return out


LN_BWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 14520, 14528)
# the softmax backward's: the forward's N and the rows route's last and
# the register routes' first (512, 513); N = 300000 takes "loop"
SOFTMAX_BWD_EDGE_N = (1, 2, 10, 33, 512, 513, 1000, 1024, 30522, 70000)
# the scan's (rows, N): "row" at the table's, the short and the many-row
# shapes, "split" from the first N past 4 tiles, at a chunk edge (3 x 175
# tiles + 1) and on the long rows
CUMSUM_EDGE = ((1, 1), (37, 300), (4096, 1024), (1, 4096), (1056, 5000),
               (1, 4097), (1055, 5000), (2, 3 * 1024 * 175 + 1),
               (3, 1000003), (1, 1000003), (132, 100000), (1, 2 ** 24))
RMS_BWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 14528)
# the reduce's element counts, each 16-byte aligned and one element past;
# 16, 64 and 768 are the zoo's loss and accuracy means (ResNet-50, DLRM and
# the NMT: phases 21-23)
REDUCE_EDGE_N = (0, 1, 16, 64, 768, 4096, 4097, 1000003, 2 ** 26)


def bwd_route_edges(torch, g):
    """layernorm_bwd, rmsnorm_bwd, reduce, softmax_bwd and cumsum against
    their plain versions at the edge shapes, every route of the five
    plans, at the path-shape checks' tolerances; dx, dgamma / dbeta, the
    reduction, the softmax backward and the scan the same bits on two
    calls, the last two also the bits of their routes' emulations
    (`softmax_bwd_split_plain`, `cumsum_split_plain`); a LayerNorm row
    with gamma wider than the block route stages raises ValueError, where
    the parent's launch failed, and an RMSNorm row wider than
    MAX_BWD_COLS, where the parent raised. Also the reduce at the last n
    of "cta" and the first of "grid", at every 16-byte phase of the
    start. Returns {kernel: summary}."""
    from flexflow_tpu_torch.kernels import norm, reduction

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dx_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    out = {k: {"checked": 0, "routes": {}, "max_abs_err": 0.0}
           for k in ("layernorm_bwd", "rmsnorm_bwd", "reduce", "softmax_bwd",
                     "cumsum")}

    def note(name, route, err):
        rec = out[name]
        rec["checked"] += 1
        rec["routes"][route] = rec["routes"].get(route, 0) + 1
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    for dtype in (torch.float32, torch.bfloat16):
        for rows in LN_EDGE_R:
            for n in LN_BWD_EDGE_N:
                for affine in (True, False):
                    x = (torch.randn((rows, n), generator=g, device=dev) * 2
                         + 1).to(dtype)
                    dy = torch.randn((rows, n), generator=g,
                                     device=dev).to(dtype)
                    gamma = beta = None
                    if affine:
                        gamma = torch.rand((n,), generator=g,
                                           device=dev) + 0.5
                        beta = torch.zeros_like(gamma)
                    shape = (f"R={rows} N={n} {dtype} "
                             f"{'affine' if affine else 'plain'}").replace(
                                 "torch.", "")
                    _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
                    if affine and n > norm.LN_BWD_BLOCK_AFFINE_MAX_N:
                        try:
                            norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                        except ValueError:
                            out["layernorm_bwd"]["refused"] = shape
                            continue
                        raise AssertionError(f"layernorm_bwd took {shape}")
                    plan = norm.layernorm_bwd_plan(rows, n, dtype, sms)
                    dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                    rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean,
                                                             rstd, dy)
                    err = _agree("layernorm_bwd (dx)", dx, rdx,
                                 dx_tol[dtype], shape)["max_abs_err"]
                    if affine:
                        for nm, a, b in (("dgamma", dg, rdg),
                                         ("dbeta", db, rdb)):
                            err = max(err, _agree(
                                f"layernorm_bwd ({nm})", a, b, (1e-3, 1e-4),
                                shape)["max_abs_err"])
                        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                        if not (torch.equal(again[1], dg)
                                and torch.equal(again[2], db)):
                            raise AssertionError(f"layernorm_bwd: {shape} "
                                                 "differs between two calls")
                    note("layernorm_bwd", plan.route, err)
                    del x, dy, dx
            for n in RMS_BWD_EDGE_N + (RMS_BWD_EDGE_N[-1] + 1,):
                for affine in (True, False):
                    x = (torch.randn((rows, n), generator=g, device=dev) * 2
                         + 1).to(dtype)
                    dy = torch.randn((rows, n), generator=g,
                                     device=dev).to(dtype)
                    gamma = torch.rand((n,), generator=g,
                                       device=dev) + 0.5 if affine else None
                    shape = (f"R={rows} N={n} {dtype} "
                             f"{'affine' if affine else 'plain'}").replace(
                                 "torch.", "")
                    _, rstd = norm.rmsnorm_fwd(x, gamma)
                    if n > norm.MAX_BWD_COLS:
                        try:
                            norm.rmsnorm_bwd(x, gamma, rstd, dy)
                        except ValueError:
                            out["rmsnorm_bwd"]["refused"] = shape
                            continue
                        raise AssertionError(f"rmsnorm_bwd took {shape}")
                    plan = norm.rmsnorm_bwd_plan(rows, n, dtype, sms)
                    dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
                    rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
                    err = _agree("rmsnorm_bwd (dx)", dx, rdx, dx_tol[dtype],
                                 shape)["max_abs_err"]
                    again = norm.rmsnorm_bwd(x, gamma, rstd, dy)
                    if not torch.equal(again[0], dx):
                        raise AssertionError(f"rmsnorm_bwd: {shape} differs "
                                             "between two calls")
                    if affine:
                        err = max(err, _agree(
                            "rmsnorm_bwd (dgamma)", dg, rdg, (1e-3, 1e-4),
                            shape)["max_abs_err"])
                        if not torch.equal(again[1], dg):
                            raise AssertionError(f"rmsnorm_bwd: {shape} "
                                                 "differs between two calls")
                    note("rmsnorm_bwd", plan.route, err)
                    del x, dy, dx, again
    for dtype in (torch.float32, torch.bfloat16):
        last = reduction.REDUCE_CTA_MAX_BYTES // (
            4 if dtype == torch.float32 else 2)
        cases = [(n, off) for n in REDUCE_EDGE_N for off in (0, 1)]
        cases += [(n, off) for n in (last, last + 1)
                  for off in range(16 // (4 if dtype == torch.float32
                                          else 2))]
        for n, off in cases:
            x = torch.randn((n + off,), generator=g, device=dev).to(
                dtype)[off:]
            plan = reduction.reduce_plan(n, dtype)
            for kind in ("sum", "mean", "max"):
                shape = f"n={n} +{off} {dtype} {kind}".replace("torch.", "")
                got = reduction.reduce(x, kind)
                ref = reduction.reduce_plain(x, kind)
                err = abs(float(got) - float(ref)) if n or kind != "max" \
                    else 0.0
                lim = 1e-6 * float(x.float().abs().sum())
                ok = torch.equal(got, ref) if kind == "max" else err <= lim
                if not ok or not torch.equal(reduction.reduce(x, kind), got):
                    raise AssertionError(f"reduce at {shape}: {float(got)} "
                                         f"vs plain {float(ref)}, or two "
                                         "calls differ")
                note("reduce", plan.route, err)
            del x
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n in ([(r, n) for n in SOFTMAX_BWD_EDGE_N
                         for r in NORM_EDGE_R] + [(1, 300000), (3, 300000)]):
            y = norm.softmax_fwd((torch.randn((rows, n), generator=g,
                                              device=dev) * 3).to(dtype))
            dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
            shape = f"R={rows} N={n} {dtype}".replace("torch.", "")
            plan = norm.softmax_bwd_plan(rows, n, dtype, sms)
            dx = norm.softmax_bwd(y, dy)
            err = _agree("softmax_bwd", dx, norm.softmax_bwd_plain(y, dy),
                         (1e-6, 1e-4) if dtype == torch.float32
                         else (1e-4, 1e-2), shape)["max_abs_err"]
            emu = norm.softmax_bwd_split_plain(y, dy, plan.cluster,
                                               y.data_ptr() % 16)
            if not (torch.equal(dx, emu)
                    and torch.equal(norm.softmax_bwd(y, dy), dx)):
                raise AssertionError(f"softmax_bwd at {shape} ({plan}): not "
                                     "the bits of its emulation, or two "
                                     "calls differ")
            note("softmax_bwd", plan.route, err)
            del y, dy, dx, emu
        for rows, n in CUMSUM_EDGE:
            x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
            plan = reduction.cumsum_plan(rows, n, dtype, sms)
            for reverse in (False, True):
                shape = (f"R={rows} N={n} {dtype}"
                         f"{' reverse' if reverse else ''}").replace(
                             "torch.", "")
                note("cumsum", plan.route, cumsum_case(
                    torch, reduction, x, reverse, sms, shape))
            del x
    missing = [f"{k}/{r}" for k, routes in (
        ("layernorm_bwd", norm.LN_BWD_ROUTES),
        ("rmsnorm_bwd", norm.RMS_BWD_ROUTES),
        ("reduce", reduction.REDUCE_ROUTES),
        ("softmax_bwd", norm.SOFTMAX_BWD_ROUTES),
        ("cumsum", reduction.CUMSUM_ROUTES)) for r in routes
        if r not in out[k]["routes"]]
    if missing:
        raise AssertionError(f"routes never held at the edges: {missing}")
    out["layernorm_bwd"]["tolerance"] = (
        "dx the path shapes' (f32 and bf16); dgamma, dbeta |err| <= 1e-3 + "
        "1e-4*|plain|")
    out["rmsnorm_bwd"]["tolerance"] = (
        "dx the path shapes' (f32 and bf16); dgamma |err| <= 1e-3 + "
        "1e-4*|plain|")
    out["reduce"]["tolerance"] = "max exact; sum, mean |err| <= 1e-6 sum|x|"
    out["softmax_bwd"]["tolerance"] = (
        "the path shapes' (f32 and bf16); dx the bits of "
        "softmax_bwd_split_plain")
    out["cumsum"]["tolerance"] = (
        "the kernel row's; out the bits of cumsum_split_plain, forward and "
        "reverse")
    for rec in out.values():
        rec["same_bits_on_two_calls"] = True
    return out


def _agree(name, out, ref, tol, shape):
    err = (out.float() - ref.float()).abs()
    row = {"shape": shape, "max_abs_err": float(err.max()),
           "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|"}
    if not bool((err <= tol[0] + tol[1] * ref.float().abs()).all()):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}: {row}")
    return row


def train_kernels(torch, F, g):
    """The training path's kernels against their plain versions at the
    training shapes, in f32 and bf16; timed in bf16 (the training path's
    dtype). Returns {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import norm

    dev = torch.device("cuda")
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], 64
    e = h * d
    scale = d ** -0.5
    table = {}
    f32_tol = (1e-5, 1e-4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # flash forward and backward, (b, l, h*d), not causal (BERT)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (rnd(b, l, e).to(dtype) for _ in range(4))
        shape = f"b={b} l={l} h={h} d={d} {dtype}".replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (4e-3, 2e-2)
        o, lse = fa.flash_fwd(q, k, v, h, scale=scale)
        ro, rlse = fa.flash_fwd_plain(q, k, v, h, scale, False)
        fwd = _agree("flash_fwd", o, ro, tol, shape)
        _agree("flash_fwd (lse)", lse, rlse, f32_tol, shape)
        grads = fa.flash_bwd(q, k, v, o, lse, do, h, scale=scale)
        delta = (do.float() * o.float()).reshape(b, l, h, d).sum(-1)
        ref = fa.flash_bwd_plain(q, k, v, do, lse, delta, h, scale, False)
        # bf16: the same bf16-rounded ds and p as the plain version; f32
        # sums in another order may move a result by one bf16 ulp (<= 2^-7)
        btol = f32_tol if dtype == torch.float32 else (1e-3, 1e-2)
        bwd = [_agree(f"flash_bwd ({n})", a, r, btol, shape)
               for n, a, r in zip(("dq", "dk", "dv"), grads, ref)]
        bwd = dict(bwd[0], max_abs_err=max(r["max_abs_err"] for r in bwd))
    torch.cuda.synchronize()
    esz = q.element_size()
    fwd_bytes = 4 * b * l * e * esz + b * l * h * 4
    fwd_bound = _bound(fwd_bytes, 4 * b * h * l * l * d, "bfloat16")
    bwd_bytes = 8 * b * l * e * esz + 2 * b * l * h * 4
    bwd_bound = _bound(bwd_bytes, 10 * b * h * l * l * d, "bfloat16")
    qt, kt, vt, dot = (t.reshape(b, l, h, d).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    fwd.update(
        ms=_time_ms(torch, lambda: fa.flash_fwd(q, k, v, h, scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, h, scale, False)),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library="F.scaled_dot_product_attention on (b, h, l, d)")
    # the serving paths' causal forward: one-shot prefill (b = 1) and the
    # session's prefill (b = 8) at the serve LM's window; the bound counts
    # half of the non-causal products (the masked half is work the card
    # need not do)
    fwd["serving_causal"] = {}
    for sb in (1, 8):
        q, k, v = (rnd(sb, l, e).to(torch.bfloat16) for _ in range(3))
        shape = f"b={sb} l={l} h={h} d={d} bfloat16 causal"
        o, lse = fa.flash_fwd(q, k, v, h, scale=scale, causal=True)
        ro, _ = fa.flash_fwd_plain(q, k, v, h, scale, True)
        row = _agree("flash_fwd (causal)", o, ro, (4e-3, 2e-2), shape)
        bound = _bound(4 * sb * l * e * 2 + sb * l * h * 4,
                       2 * sb * h * l * l * d, "bfloat16")
        qt, kt, vt = (t.reshape(sb, l, h, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        row.update(
            ms=_time_ms(torch, lambda: fa.flash_fwd(
                q, k, v, h, scale=scale, causal=True)),
            plain_ms=_time_ms(torch, lambda: fa.flash_fwd_plain(
                q, k, v, h, scale, True)),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale, is_causal=True)),
            bound_ms=bound[0], bound_by=bound[1],
            library="F.scaled_dot_product_attention(is_causal=True) on "
                    "(b, h, l, d)")
        row["vs_library"] = row["ms"] / row["library_ms"]
        fwd["serving_causal"][f"b={sb}"] = row
    fwd["vs_library"] = fwd["ms"] / fwd["library_ms"]
    table["flash_fwd"] = fwd
    bwd.update(
        ms=_time_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, h,
                                                scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, do, lse, delta, h, scale, False)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library="SDPA's backward through autograd",
        ms_includes="delta = sum(dO * O) per head in torch (2 kernels: "
                    "the f32 product, the sum) + the dq and dk/dv "
                    "launches")
    table["flash_bwd"] = bwd
    del sdpa_out, qg, kg, vg

    # LayerNorm backward, R = b*l rows of the hidden width
    r, n = b * l, TRAIN["hidden"]
    for dtype in (torch.float32, torch.bfloat16):
        x = (rnd(r, n) * 2 + 1).to(dtype)
        dy = rnd(r, n).to(dtype)
        gamma, beta = rnd(n).abs() + 0.5, rnd(n)
        _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
        dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
        shape = f"R={r} N={n} {dtype}".replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (2e-2, 2e-2)
        ln = _agree("layernorm_bwd (dx)", dx, rdx, tol, shape)
        # dgamma / dbeta: f32 sums over 4096 rows in another order
        for nm, a, ref_ in (("dgamma", dg, rdg), ("dbeta", db, rdb)):
            row = _agree(f"layernorm_bwd ({nm})", a, ref_, (1e-3, 1e-4),
                         shape)
            ln["max_abs_err"] = max(ln["max_abs_err"], row["max_abs_err"])
        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        if not (torch.equal(again[1], dg) and torch.equal(again[2], db)):
            raise AssertionError("layernorm_bwd: dgamma / dbeta differ "
                                 "between two runs")
        # the warp route's every step is rounded on its own: the CPU
        # emulation of its order gives the kernel's bits
        plan = norm.layernorm_bwd_plan(r, n, dtype, torch.cuda.
                                       get_device_properties(dev).
                                       multi_processor_count)
        emu = norm.layernorm_bwd_warp_plain(
            x.cpu(), gamma.cpu(), mean.cpu(), rstd.cpu(), dy.cpu(),
            plan.blocks, x.data_ptr() % 16, plan.threads // 32)
        if plan.route != "warp" or not all(
                torch.equal(a.cpu(), b) for a, b in zip((dx, dg, db), emu)):
            raise AssertionError(f"layernorm_bwd at {shape}: {plan}, or not "
                                 "the bits of layernorm_bwd_warp_plain")
    ln["plan"] = plan._asdict()
    ln["warp_plain_same_bits"] = True
    g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n], g16, b16,
                                                       1e-5)
    esz = x.element_size()
    ln_bytes = 3 * r * n * esz + 2 * r * 4 + 3 * n * 4
    ln_bound = _bound(ln_bytes, 10 * r * n, "bfloat16")
    ln.update(
        ms=_time_ms(torch, lambda: norm.layernorm_bwd(x, gamma, mean, rstd,
                                                      dy)),
        plain_ms=_time_ms(torch, lambda: norm.layernorm_bwd_plain(
            x, gamma, mean, rstd, dy)),
        library_ms=_time_ms(
            torch, lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [n], lmean, lrstd, g16, b16, [True, True, True])),
        bound_ms=ln_bound[0], bound_by=ln_bound[1],
        library="torch.ops.aten.native_layer_norm_backward (bf16 gamma)",
        ms_includes="2 launches (the warp route's rows, then the dgamma / "
                    "dbeta column sums as a programmatic dependent)")
    table["layernorm_bwd"] = ln

    # softmax backward: the classifier's (b*l, 2) probabilities (the
    # table's row), the tier's (4096, 10), and the wide shapes of its
    # other routes; every one the bits of its route's emulation. The
    # paths give it f32 (the autograd Function saves y in f32, whatever
    # the activations' dtype); bf16 is held too
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for path, r, n in (("train step", b * l, 2), ("tier step", 4096, 10),
                       ("cluster", 8, 30522), ("cluster 16", 16, 30522),
                       ("block", 128, 30522), ("NMT projection", 2048, 32000),
                       ("block mid", 4096, 1024), ("NMT step", 768, 32000),
                       ("ResNet step", 16, 10), ("DLRM step", 64, 2),
                       ("MoE switch gate", 1024, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            y = norm.softmax_fwd((rnd(r, n) * 3).to(dtype))
            dy = rnd(r, n).to(dtype)
            shapes[f"{path} {str(dtype)[6:]}"] = softmax_bwd_case(
                torch, norm, y, dy, sms)
    sm = dict(shapes.pop("train step float32"),
              library="torch._softmax_backward_data",
              ms_includes="1 launch",
              note="N = 2: bound by launch latency, not by bytes")
    sm["path_shapes"] = shapes
    table["softmax_bwd"] = sm
    return table


def softmax_bwd_case(torch, norm, y, dy, sms):
    """softmax_bwd on (y, dy): within tolerance of its plain version,
    equal to the bit to its route's emulation (`softmax_bwd_split_plain`,
    run on the card in torch's elementwise kernels) and the same bits on
    two calls; timed beside its plain version and
    `torch._softmax_backward_data`, hot in L2 (the cotangent arrives from
    the op before). Returns a table row with the plan."""
    rows, n = y.shape
    shape = f"R={rows} N={n} {y.dtype}".replace("torch.", "")
    plan = norm.softmax_bwd_plan(rows, n, y.dtype, sms)
    dx = norm.softmax_bwd(y, dy)
    row = _agree("softmax_bwd", dx, norm.softmax_bwd_plain(y, dy),
                 (1e-6, 1e-4) if y.dtype == torch.float32 else (1e-4, 1e-2),
                 shape)
    emu = norm.softmax_bwd_split_plain(y, dy, plan.cluster,
                                       y.data_ptr() % 16)
    if not (torch.equal(dx, emu) and torch.equal(norm.softmax_bwd(y, dy),
                                                 dx)):
        raise AssertionError(f"softmax_bwd at {shape} ({plan}): not the "
                             "bits of its emulation, or two calls differ")
    bound, by = _bound(3 * y.numel() * y.element_size(), 4 * y.numel(),
                       str(y.dtype)[6:])
    row.update(plan=plan._asdict(), emulation_same_bits=True,
               ms=_time_ms(torch, lambda: norm.softmax_bwd(y, dy)),
               plain_ms=_time_ms(torch, lambda: norm.softmax_bwd_plain(y,
                                                                       dy)),
               library_ms=_time_ms(torch, lambda: torch.
                                   _softmax_backward_data(dy, y, -1,
                                                          y.dtype)),
               bound_ms=bound, bound_by=by)
    return row


def tier_kernels(torch, F, g):
    """RMSNorm forward and backward and the scalar reduction against their
    plain versions, in f32 and bf16, at the kernel-tier graph's shapes
    (RMSNorm (4096, 1024); the loss and accuracy terms, 4096 f32
    elements), at edge shapes, and the reduction at 2^26 f32 elements;
    dgamma and the reduction bit-identical over two runs; RMSNorm
    backward at (4096, 1024) the bits of its warp route's emulation. Timed
    at the path's shapes (bf16 RMSNorm; the backward also in f32). Returns
    {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import norm, reduction

    dev = torch.device("cuda")
    table = {}
    f32_tol = (1e-5, 1e-4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def rms_case(rows, n, dtype, affine):
        x = (rnd(rows, n) * 2 + 1).to(dtype)
        dy = rnd(rows, n).to(dtype)
        gamma = rnd(n).abs() + 0.5 if affine else None
        shape = (f"R={rows} N={n} {dtype} "
                 f"{'affine' if affine else 'plain'}").replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (2e-2, 2e-2)
        y, rstd = norm.rmsnorm_fwd(x, gamma)
        y2, rstd2 = norm.rmsnorm_fwd(x, gamma)
        if not (torch.equal(y2, y) and torch.equal(rstd2, rstd)):
            raise AssertionError(f"rmsnorm_fwd: {shape} differs between two "
                                 "calls")
        ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
        fwd = _agree("rmsnorm_fwd", y, ry, tol, shape)
        fwd["plan"] = norm.rmsnorm_plan(rows, n, dtype)._asdict()
        _agree("rmsnorm_fwd (rstd)", rstd, rrstd, f32_tol, shape)
        dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
        rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
        bwd = _agree("rmsnorm_bwd (dx)", dx, rdx, tol, shape)
        plan = norm.rmsnorm_bwd_plan(rows, n, dtype, torch.cuda.
                                     get_device_properties(dev).
                                     multi_processor_count)
        bwd["plan"] = plan._asdict()
        if rows == TRAIN["batch"] * TRAIN["seq"]:
            # the warp route's every step is rounded on its own: the CPU
            # emulation of its order gives the kernel's bits
            emu = norm.rmsnorm_bwd_warp_plain(
                x.cpu(), gamma.cpu() if affine else None, rstd.cpu(),
                dy.cpu(), plan.blocks, x.data_ptr() % 16, plan.threads // 32)
            if plan.route != "warp" or not torch.equal(dx.cpu(), emu[0]) \
                    or (affine and not torch.equal(dg.cpu(), emu[1])):
                raise AssertionError(f"rmsnorm_bwd at {shape}: {plan}, or "
                                     "not the bits of rmsnorm_bwd_warp_plain")
            bwd["warp_plain_same_bits"] = True
        if affine:
            # dgamma: f32 sums over the rows in another order
            row = _agree("rmsnorm_bwd (dgamma)", dg, rdg, (1e-3, 1e-4), shape)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], row["max_abs_err"])
            if not torch.equal(norm.rmsnorm_bwd(x, gamma, rstd, dy)[1], dg):
                raise AssertionError("rmsnorm_bwd: dgamma differs between "
                                     "two runs")
        return fwd, bwd, (x, gamma, rstd, dy)

    r, n = TRAIN["batch"] * TRAIN["seq"], TRAIN["hidden"]
    worst = {"rmsnorm_fwd": 0.0, "rmsnorm_bwd": 0.0}
    edges, timed = [], {}
    for rows, cols in ((r, n), (37, 300), (4095, 1000), (1, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            for affine in (True, False):
                fwd, bwd, args = rms_case(rows, cols, dtype, affine)
                worst["rmsnorm_fwd"] = max(worst["rmsnorm_fwd"],
                                           fwd["max_abs_err"])
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"],
                                           bwd["max_abs_err"])
                if (rows, cols) != (r, n):
                    edges.append(fwd["shape"])
                elif affine:
                    timed[dtype] = (fwd, bwd, args)
    fwd, bwd, (x, gamma, rstd, dy) = timed[torch.bfloat16]
    esz = x.element_size()
    g16 = gamma.to(x.dtype)
    xg = x.detach().requires_grad_()
    wg = g16.detach().requires_grad_()
    lib_out = F.rms_norm(xg, (n,), wg, 1e-6)
    fwd_bound = _bound(2 * r * n * esz + n * 4 + r * 4, 4 * r * n,
                       "bfloat16")
    bwd_bound = _bound(3 * r * n * esz + 2 * n * 4 + r * 4, 8 * r * n,
                       "bfloat16")
    fwd.update(
        max_abs_err=worst["rmsnorm_fwd"], edge_shapes=edges,
        ms=_time_ms(torch, lambda: norm.rmsnorm_fwd(x, gamma)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_fwd_plain(
            x, gamma, 1e-6)),
        library_ms=_time_ms(torch, lambda: F.rms_norm(x, (n,), g16, 1e-6)),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library="F.rms_norm (bf16 weight)")
    table["rmsnorm_fwd"] = fwd
    bwd.update(
        max_abs_err=worst["rmsnorm_bwd"], edge_shapes=edges,
        ms=_time_ms(torch, lambda: norm.rmsnorm_bwd(x, gamma, rstd, dy)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_bwd_plain(
            x, gamma, rstd, dy)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xg, wg), dy, retain_graph=True)),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library="F.rms_norm's backward through autograd (bf16 weight)",
        ms_includes="2 launches (the warp route's rows, then the dgamma "
                    "column sums as a programmatic dependent)")
    # the f32 shape, beside F.rms_norm's backward with an f32 weight
    _, f32_bwd, (x, gamma, rstd, dy) = timed[torch.float32]
    xg = x.detach().requires_grad_()
    wg = gamma.detach().requires_grad_()
    lib_out = F.rms_norm(xg, (n,), wg, 1e-6)
    f32_bound = _bound(3 * r * n * 4 + 2 * n * 4 + r * 4, 8 * r * n,
                       "float32")
    f32_bwd.update(
        ms=_time_ms(torch, lambda: norm.rmsnorm_bwd(x, gamma, rstd, dy)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_bwd_plain(
            x, gamma, rstd, dy)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xg, wg), dy, retain_graph=True)),
        bound_ms=f32_bound[0], bound_by=f32_bound[1])
    bwd["f32_shape"] = f32_bwd
    table["rmsnorm_bwd"] = bwd
    del lib_out, xg, wg

    def reduce_case(x, kind):
        out = reduction.reduce(x, kind)
        ref = reduction.reduce_plain(x, kind)
        shape = f"n={x.numel()} {x.dtype} {kind}".replace("torch.", "")
        err = abs(float(out) - float(ref)) if x.numel() or kind != "max" \
            else 0.0
        if kind == "max":
            ok = torch.equal(out, ref)
            tol = "exact"
        else:
            lim = 1e-6 * float(x.float().abs().sum())
            ok = err <= lim
            tol = f"|err| <= 1e-6 * sum|x| = {lim}"
        if not ok or out.dtype != torch.float32 or out.shape != ():
            raise AssertionError(f"reduce disagrees with its plain version "
                                 f"at {shape}: {float(out)} vs {float(ref)}")
        if not torch.equal(reduction.reduce(x, kind), out):
            raise AssertionError(f"reduce: {shape} differs between two runs")
        return {"shape": shape, "max_abs_err": err, "tolerance": tol}

    rows = []
    for numel in (4096, 0, 1, 4097, 1000003):
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(numel).to(dtype)
            for kind in ("sum", "mean", "max"):
                rows.append(reduce_case(x, kind))
                if numel > 1:  # off the 16-byte boundary: scalar loads
                    rows.append(reduce_case(x[1:], kind))
    # the loss's (b, l, 1) log-likelihoods and the accuracy's (b, l) hits
    ll = -(rnd(TRAIN["batch"], TRAIN["seq"], 1).abs())
    big = rnd(2 ** 26)
    for kind in ("sum", "max"):
        rows.append(reduce_case(big, kind))
    red = dict(reduce_case(ll, "mean"))
    red.update(
        max_abs_err=max(row["max_abs_err"] for row in rows),
        checked=[row["shape"] for row in rows],
        ms=_time_ms(torch, lambda: reduction.reduce(ll, "mean")),
        plain_ms=_time_ms(torch, lambda: reduction.reduce_plain(ll, "mean")),
        library_ms=_time_ms(torch, lambda: torch.sum(ll)),
        bound_ms=_bound(ll.numel() * 4 + 4, ll.numel(), "float32")[0],
        bound_by="bytes", library="torch.sum",
        plan=reduction.reduce_plan(ll.numel(), ll.dtype)._asdict(),
        ms_includes="1 launch (the cta route)",
        note="4096 elements: launch latency rules")
    large = {}
    for kind, lib in (("sum", torch.sum), ("max", torch.amax)):
        b_ms, by = _bound(big.numel() * 4 + 4, big.numel(), "float32")
        large[kind] = dict(
            ms=_time_ms(torch, lambda: reduction.reduce(big, kind)),
            plain_ms=_time_ms(torch, lambda: reduction.reduce_plain(big,
                                                                    kind)),
            library_ms=_time_ms(torch, lambda: lib(big)),
            bound_ms=b_ms, bound_by=by,
            library=f"torch.{lib.__name__}",
            ms_includes="2 launches (the grid route's block partials, then "
                        "their sum as a programmatic dependent)")
    red["at_2^26_f32"] = large
    table["reduce"] = red
    del big
    return table


def heads_kernels(torch, F, g):
    """The head-separated flash kernels (B7) against their plain versions
    in both layouts: at the TP rank's shape (8, 512, 8, 64) in bf16, not
    causal and causal; at (2, 100 -> 130, 3, 64) in f32 (lq != lk); at
    head dim 128. Timed at the rank's shape, bf16, not causal (BERT).
    Returns {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    table = {}
    f32_tol, bf16_tol = (1e-5, 1e-4), (4e-3, 2e-2)
    # bf16 gradients: the same rounded ds and p as the plain version, f32
    # sums in another order move a result by one bf16 ulp (<= 2^-7)
    grad_tol = {torch.float32: f32_tol, torch.bfloat16: (1e-3, 1e-2)}
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"] // 2, 64

    def make(layout, bb, lq, lk, hh, dd, dtype):
        def rnd(n):
            x = torch.randn((bb, n, hh, dd), generator=g, device=dev)
            x = x.to(dtype)
            return x.transpose(1, 2).contiguous() if layout == "bhld" else x
        return rnd(lq), rnd(lk), rnd(lk), rnd(lq)

    def check(layout, bb, lq, lk, hh, dd, dtype, causal):
        q, k, v, do = make(layout, bb, lq, lk, hh, dd, dtype)
        scale = dd ** -0.5
        shape = (f"b={bb} lq={lq} lk={lk} h={hh} d={dd} {layout} {dtype}"
                 f"{' causal' if causal else ''}").replace("torch.", "")
        o, lse = fa.flash_fwd_heads(q, k, v, scale=scale, causal=causal,
                                    layout=layout)
        ro, rlse = fa.flash_fwd_heads_plain(q, k, v, scale, causal, layout)
        fwd = _agree("flash_fwd_heads", o, ro,
                     f32_tol if dtype == torch.float32 else bf16_tol, shape)
        _agree("flash_fwd_heads (lse)", lse, rlse, f32_tol, shape)
        grads = fa.flash_bwd_heads(q, k, v, o, lse, do, scale=scale,
                                   causal=causal, layout=layout)
        delta = (do.float() * o.float()).sum(-1)
        if layout == "blhd":
            delta = delta.transpose(1, 2)
        ref = fa.flash_bwd_heads_plain(q, k, v, do, lse, delta, scale,
                                       causal, layout)
        rows = [_agree(f"flash_bwd_heads (d{n})", a, r_, grad_tol[dtype],
                       shape) for n, a, r_ in zip("qkv", grads, ref)]
        bwd = dict(rows[0], max_abs_err=max(r_["max_abs_err"]
                                            for r_ in rows))
        return fwd, bwd, (q, k, v, o, lse, do, delta)

    for layout in fa.LAYOUTS:
        worst = {"fwd": 0.0, "bwd": 0.0}
        checked = []
        for case in ((b, l, l, h, d, torch.bfloat16, True),
                     (2, 100, 130, 3, 64, torch.float32, True),
                     (2, 100, 130, 3, 64, torch.float32, False),
                     (2, 70, 33, 2, 128, torch.bfloat16, True),
                     (2, 70, 33, 2, 128, torch.float32, False),
                     (b, l, l, h, d, torch.bfloat16, False)):
            fwd, bwd, args = check(layout, *case)
            worst["fwd"] = max(worst["fwd"], fwd["max_abs_err"])
            worst["bwd"] = max(worst["bwd"], bwd["max_abs_err"])
            checked.append(fwd["shape"])
        # the last case is the rank's shape, bf16, not causal: timed
        q, k, v, o, lse, do, delta = args
        scale = d ** -0.5
        torch.cuda.synchronize()
        esz = q.element_size()
        fwd_bound = _bound(4 * b * l * h * d * esz + b * h * l * 4,
                           4 * b * h * l * l * d, "bfloat16")
        bwd_bound = _bound(8 * b * l * h * d * esz + 2 * b * h * l * 4,
                           10 * b * h * l * l * d, "bfloat16")
        qt, kt, vt, dot = (t.transpose(1, 2) if layout == "blhd" else t
                           for t in (q, k, v, do))
        qt, kt, vt, dot = (t.contiguous() for t in (qt, kt, vt, dot))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        fwd.update(
            max_abs_err=worst["fwd"], checked=checked,
            ms=_time_ms(torch, lambda: fa.flash_fwd_heads(
                q, k, v, scale=scale, layout=layout)),
            plain_ms=_time_ms(torch, lambda: fa.flash_fwd_heads_plain(
                q, k, v, scale, False, layout)),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale)),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library="F.scaled_dot_product_attention on (b, h, l, d)")
        bwd.update(
            max_abs_err=worst["bwd"], checked=checked,
            ms=_time_ms(torch, lambda: fa.flash_bwd_heads(
                q, k, v, o, lse, do, scale=scale, layout=layout)),
            plain_ms=_time_ms(torch, lambda: fa.flash_bwd_heads_plain(
                q, k, v, do, lse, delta, scale, False, layout)),
            library_ms=_time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library="SDPA's backward through autograd",
            ms_includes="delta = sum(dO * O) per head in torch (2 kernels: "
                    "the f32 product, the sum) + the dq and dk/dv "
                    "launches")
        table[f"flash_fwd_{layout}"] = fwd
        table[f"flash_bwd_{layout}"] = bwd
        del sdpa_out, qg, kg, vg
    return table


def cumsum_kernels(torch, g):
    """The scan (B9) against its plain version and, to the bit, its
    route's emulation (`cumsum_split_plain`, run on the card in torch's
    elementwise adds), forward and reverse, at (4096, 1024) f32 and bf16
    and (1, 1), (37, 300) ("row") and (3, 1000003) ("split"); timed at the
    kernel table's shapes: (4096, 1024) f32 (the row) and bf16, (3,
    1000003) f32 forward and reverse, (1, 2^24) f32 and (1, 1000003) bf16.
    Returns {"cumsum": table row}."""
    from flexflow_tpu_torch.kernels import reduction

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    for shape in ((4096, 1024), (1, 1), (37, 300), (3, 1000003)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for reverse in (False, True):
                name = (f"R={shape[0]} N={shape[1]} {dtype}"
                        f"{' reverse' if reverse else ''}").replace(
                            "torch.", "")
                worst = max(worst, cumsum_case(torch, reduction, x, reverse,
                                               sms, name))
                rows.append(name)
    row = {"shape": "R=4096 N=1024 float32", "max_abs_err": worst,
           "checked": rows, "emulation_same_bits": True,
           "tolerance": "|err| <= 1e-5 cumsum(|x|) + 1e-6 (+ 2^-7 |plain| "
                        "in bf16)"}
    notes = {}
    for shape, dtype, reverse in (((4096, 1024), torch.float32, False),
                                  ((4096, 1024), torch.bfloat16, False),
                                  ((3, 1000003), torch.float32, False),
                                  ((3, 1000003), torch.float32, True),
                                  ((1, 2 ** 24), torch.float32, False),
                                  ((1, 1000003), torch.bfloat16, False)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        n = x.numel()
        bound, by = _bound(2 * n * x.element_size(), n, "float32")
        plan = reduction.cumsum_plan(*shape, dtype, sms)
        t = dict(plan=plan._asdict(),
                 ms=_time_ms(torch, lambda: reduction.cumsum(
                     x, reverse=reverse)),
                 plain_ms=_time_ms(torch, lambda: reduction.cumsum_plain(
                     x, reverse=reverse)),
                 library_ms=_time_ms(torch, lambda: torch.cumsum(x, -1)),
                 bound_ms=bound, bound_by=by,
                 ms_includes=("2 launches (the chunk totals, then the scan "
                              "as a programmatic dependent)"
                              if plan.route == "split" else "1 launch"))
        if not notes:
            row.update(t, library="torch.cumsum along the last axis (the "
                                  "forward scan, also beside the reverse)")
        notes[f"R={shape[0]} N={shape[1]} {dtype}"
              f"{' reverse' if reverse else ''}".replace("torch.", "")] = t
        del x
    row["timed"] = notes
    return {"cumsum": row}


def cumsum_case(torch, reduction, x, reverse, sms, name):
    """cumsum of x within tolerance of its plain version, equal to the bit
    to `cumsum_split_plain` at its plan's chunk, the same bits on two
    calls; returns the largest difference from the plain version."""
    plan = reduction.cumsum_plan(x.numel() // x.shape[-1], x.shape[-1],
                                 x.dtype, sms)
    out = reduction.cumsum(x, reverse=reverse)
    ref = reduction.cumsum_plain(x, reverse=reverse)
    # f32 sums in another order: a few ulps of the running sum of |x|;
    # bf16 one rounding more
    lim = 1e-5 * reduction.cumsum_plain(x.float().abs(), reverse) + 1e-6
    if x.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    if out.dtype != x.dtype or not bool((err <= lim).all()):
        raise AssertionError(f"cumsum disagrees with its plain version at "
                             f"{name}: max err {float(err.max())}")
    emu = reduction.cumsum_split_plain(
        x, plan.chunk if plan.route == "split" else None, reverse)
    if not (torch.equal(out, emu)
            and torch.equal(reduction.cumsum(x, reverse=reverse), out)):
        raise AssertionError(f"cumsum at {name} ({plan}): not the bits of "
                             "its emulation, or two calls differ")
    return float(err.max())


def phase_standalone(torch):
    """The public entries no model path calls, driven as a user calls
    them: flash_attention_heads(layout="bhld") forward and backward at the
    TP rank's shape (bf16), fused_cumsum forward and backward at (4096,
    1024) f32 (the "row" route) and cumsum at (3, 1000003) f32 (the
    "split" route), counts from 0; each result finite and equal to its
    plain version's within the kernels phase's tolerances."""
    from flexflow_tpu_torch.kernels import (flash_attention as fa,
                                            launch_counts, reduction,
                                            reset_launch_counts)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(77)
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"] // 2, 64
    q, k, v, do = (torch.randn((b, h, l, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    x = torch.randn((4096, 1024), generator=g, device=dev)
    gx = torch.randn((4096, 1024), generator=g, device=dev)
    long_x = torch.randn((3, 1000003), generator=g, device=dev)
    qg, kg, vg, xg = (t.clone().requires_grad_() for t in (q, k, v, x))
    torch.cuda.synchronize()
    reset_launch_counts()
    o = fa.flash_attention_heads(qg, kg, vg, layout="bhld")
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    c = reduction.fused_cumsum(xg)
    (dx,) = torch.autograd.grad(c, xg, gx)
    long_c = reduction.cumsum(long_x)
    torch.cuda.synchronize()
    launches = launch_counts()
    wrong = {k_: launches[k_] for k_, n in STANDALONE_LAUNCHES.items()
             if launches[k_] != n}
    if wrong:
        raise AssertionError(f"standalone launches {wrong}, expected "
                             f"{STANDALONE_LAUNCHES}")
    ro, rlse = fa.flash_fwd_heads_plain(q, k, v, d ** -0.5, False, "bhld")
    o, c = o.detach(), c.detach()
    checks = [_agree("flash_attention_heads", o, ro, (4e-3, 2e-2),
                     "bhld bf16")]
    delta = (do.float() * o.float()).sum(-1)
    for n, a, r_ in zip("qkv", grads, fa.flash_bwd_heads_plain(
            q, k, v, do, rlse, delta, d ** -0.5, False, "bhld")):
        checks.append(_agree(f"flash_attention_heads d{n}", a, r_,
                             (1e-3, 1e-2), "bhld bf16"))
    mag = reduction.cumsum_plain(x.abs())
    for name, a, r_, m in (
            ("fused_cumsum", c, reduction.cumsum_plain(x), mag),
            ("fused_cumsum grad", dx, reduction.cumsum_plain(gx, True),
             reduction.cumsum_plain(gx.abs(), True)),
            ("cumsum (3, 1000003) split", long_c,
             reduction.cumsum_plain(long_x), reduction.cumsum_plain(
                 long_x.abs()))):
        err = (a - r_).abs()
        if not (bool(torch.isfinite(a).all())
                and bool((err <= 1e-5 * m + 1e-6).all())):
            raise AssertionError(f"{name} disagrees with its plain version")
        checks.append({"shape": name, "max_abs_err": float(err.max())})
    return {"phase": "standalone", "launches": {k_: launches[k_] for k_ in
                                                STANDALONE_LAUNCHES},
            "checks": checks}


def _tp_jobs():
    """The tp phase's two jobs (flexflow_tpu_torch/tools/tp_train.py)."""
    x, y = _train_batch()
    cx, cy = _cross_batch()
    layers = 2
    train = {"axes": {"model": 2},
             "widths": {"num_layers": TRAIN["layers"]}, "x": x, "y": y,
             "steps": 5, "count_steps": 3, "seed": 0, "mixed": True,
             "adam": (1e-4, "bfloat16")}
    cross = {"axes": {"model": 2}, "widths": {"num_layers": layers},
             "x": cx, "y": cy, "seed": 1, "mixed": False,
             "adam": (1e-4, "bfloat16"), "grad_steps": 2,
             "grad_norms_of": (("tok_emb", "weight"), ("layer0_attn", "wq"),
                               ("layer0_attn", "wv"), ("layer0_ln1", "gamma"),
                               (f"layer{layers - 1}_ln2", "beta"),
                               ("cls", "kernel"))}
    return [train, cross]


def phase_tp(torch, train_losses, cross_card):
    """Two ranks on cuda:0 (tools/tp_train.py run_rank): the full-width
    flagship under model=2 (tp) and the train-cross model under model=2
    (tp-cross). Returns the two phase records and rank 0's launches."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_jobs(2, "cuda", _tp_jobs(), timeout_s=900)
    wall = time.perf_counter() - t0
    tp = [r["jobs"][0] for r in ranks]
    cross = [r["jobs"][1] for r in ranks]
    first = tp[0]
    for i, r in enumerate(tp[1:], 1):
        if r["losses"] != first["losses"]:
            raise AssertionError(f"tp: rank {i} losses {r['losses']} differ "
                                 f"from rank 0's {first['losses']}")
        if r["replicated_digest"] != first["replicated_digest"]:
            raise AssertionError(f"tp: rank {i}'s replicated weights differ "
                                 "from rank 0's after the last step")
    expected = {**TP_PER_STEP, **TP_ROUTES_PER_STEP}
    for i, r in enumerate(tp):
        wrong = {k: r["launches_per_step"][k] for k, n in expected.items()
                 if r["launches_per_step"][k] != n}
        if wrong:
            raise AssertionError(f"tp: rank {i} launches per step {wrong}, "
                                 f"expected {expected}")
    losses = first["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"tp: non-finite loss {losses}")
    rels = [abs(a - c) / abs(c) for a, c in zip(losses[:3],
                                                 train_losses[:3])]
    if max(rels) > 2e-2:
        raise AssertionError(f"tp: losses {losses[:3]} vs one device "
                             f"{train_losses[:3]} (relative {rels})")
    host = ranks[0]["host"]
    record = {
        "phase": "tp", "axes": {"model": 2}, "world_size":
            host["process_count"], "backend": host["backend"],
        "devices": [r["host"]["device"] for r in ranks],
        "host_staging": host["host_staging"],
        "layers": TRAIN["layers"], "steps": len(losses),
        "losses": losses, "one_device_losses": train_losses[:3],
        "max_relative_diff_first3": max(rels),
        "launches_per_step": {k: first["launches_per_step"][k]
                              for k in TP_PER_STEP},
        "routes_per_step": {k: first["launches_per_step"][k]
                            for k in TP_ROUTES_PER_STEP},
        "staged_per_step_rank0": first["staged_per_step"],
        "ms_per_step_rank0": first["ms_per_step"],
        "ms_per_step_note": "two ranks time-sharing one card over a "
                            "host-staged gloo transport: not a TP speed",
        "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in tp],
        "build_s_by_rank": [r["build_s"] for r in tp],
        "spawn_wall_s": wall,
        "tolerance": "ranks' losses and replicated weights identical; "
                     "|loss - one device| <= 2e-2 |one device|, steps 1-3"}
    for i, r in enumerate(cross[1:], 1):
        if r["steps"] != cross[0]["steps"]:
            raise AssertionError(f"tp-cross: rank {i} differs from rank 0")
    worst = _compare_steps("tp-cross", cross[0]["steps"], cross_card,
                           ("model=2", "one device"), 1e-4)
    record_cross = {
        "phase": "tp-cross", "layers": 2, "dtype": "float32",
        "optimizer": "Adam alpha 1e-4, bf16 moments",
        "tp": cross[0]["steps"], "one_device": cross_card,
        "max_relative_diff": worst,
        "tolerance": "|model=2 - one device| <= 1e-4 |one device| (loss "
                     "and each whole-gradient norm, steps 1 and 2)"}
    launches = {k: int(round(first["launches_per_step"][k] * 3))
                for k in (*TP_KERNELS, "optimizer_adam")}
    return record, record_cross, launches


# phase 35: the Unity search's budget, the world, and the train path's
# kernels every searched plan runs (attention takes the packed flash
# kernels without a model axis, the head-separated ones with it)
SEARCH_BUDGET = 10
SEARCH_RANKS = 4
SEARCH_KERNELS = ("layernorm_fwd", "layernorm_bwd", "softmax_fwd",
                  "softmax_bwd", "reduce", "optimizer_adam")


def _search_job():
    """Phase 35's job (flexflow_tpu_torch/tools/tp_train.py): the train
    phase's encoder, weights and batch, compiled with no axes under the
    Unity search (costs measured on the card)."""
    x, y = _train_batch()
    return {"axes": None, "config": {"search_budget": SEARCH_BUDGET},
            "widths": {"num_layers": TRAIN["layers"]}, "x": x, "y": y,
            "steps": 3, "count_steps": 2, "seed": 0, "mixed": True,
            "adam": (1e-4, "bfloat16"), "analytic_twice": True}


def phase_search(torch, train_losses):
    """35: the searched plan on four ranks (see the module docstring).
    Returns the phase's record and rank 0's launches over the counted
    steps."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_jobs(SEARCH_RANKS, "cuda", [_search_job()],
                       timeout_s=900)
    wall = time.perf_counter() - t0
    jobs = [r["jobs"][0] for r in ranks]
    first = jobs[0]
    plan = first["plan"]
    for i, j in enumerate(jobs[1:], 1):
        if (j["plan"]["axes"], j["plan"]["ops"]) != (plan["axes"],
                                                     plan["ops"]):
            raise AssertionError(f"search: rank {i}'s plan {j['plan']} "
                                 f"differs from rank 0's {plan}")
    cost = first["op_cost_cache"]
    if cost["failures"]:
        raise AssertionError(f"search: op-cost measurements failed: "
                             f"{cost['failures']}")
    if cost["misses"] == 0:
        raise AssertionError("search: no op cost was measured on the card")
    diag = plan.get("diagnostics", {})
    errors = {k: n for k, n in diag.items() if k.endswith("/error")}
    if errors:
        raise AssertionError(f"search: error diagnostics {errors}")
    on_mesh = [j for j in jobs if not j.get("outside_mesh")]
    past = [j for j in jobs if j.get("outside_mesh")]
    for j in past:
        if not j.get("fit_error") or "losses" in j:
            raise AssertionError(f"search: a rank past the mesh trained: "
                                 f"{j}")
    losses = on_mesh[0]["losses"]
    for j in on_mesh[1:]:
        if j["losses"] != losses:
            raise AssertionError(f"search: losses differ across the mesh: "
                                 f"{[k['losses'] for k in on_mesh]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"search: non-finite loss {losses}")
    rels = [abs(a - c) / abs(c) for a, c in zip(losses[:3],
                                                 train_losses[:3])]
    if max(rels) > 2e-2:
        raise AssertionError(f"search: losses {losses[:3]} vs one device "
                             f"{train_losses[:3]} (relative {rels})")
    per_step = first["launches_per_step"]
    flash = (("flash_fwd_blhd", "flash_bwd_blhd")
             if plan["axes"].get("model", 1) > 1
             else ("flash_fwd", "flash_bwd"))
    missing = [k for k in SEARCH_KERNELS + flash if not per_step.get(k)]
    if missing:
        raise AssertionError(f"search: kernels never launched on the "
                             f"searched plan's steps: {missing}")
    first_run, second_run = first["analytic"]
    if second_run["cache_mode"] != "hit" or (
            second_run["axes"], second_run["ops"]) != (first_run["axes"],
                                                       first_run["ops"]):
        raise AssertionError(f"search: the analytic search's second run "
                             f"{second_run['cache_mode']} is not a hit with "
                             f"the first run's plan")
    dp = plan["axes"].get("data", 1)
    by_degree = {}
    for d, t in plan["ops"].values():
        by_degree[f"dp={d},tp={t}"] = by_degree.get(f"dp={d},tp={t}", 0) + 1
    counted = _search_job()["count_steps"]
    search = plan["search"]
    record = {
        "phase": "search", "card": _card_line(), "world_size": SEARCH_RANKS,
        "backend": ranks[0]["host"]["backend"],
        "host_staging": ranks[0]["host"]["host_staging"],
        "layers": TRAIN["layers"], "search_budget": SEARCH_BUDGET,
        "measured": {"axes": plan["axes"], "ops_by_degree": by_degree,
                     "ops_off_default": {
                         k: v for k, v in plan["ops"].items()
                         if v[0] < dp or v[1] > 1},
                     "applied_rewrites": search["applied_rewrites"]},
        "predicted_step_ms": search["predicted_step_us"] / 1e3,
        "search_wall_s": search["wall_ms"] / 1e3,
        "op_cost_cache": {"hits": cost["hits"], "misses": cost["misses"],
                          "failures": len(cost["failures"])},
        "candidates_simulated": search["candidates_simulated"],
        "candidates_pruned": search["candidates_pruned"],
        "diagnostics": diag,
        "ranks_on_mesh": len(on_mesh), "ranks_past_mesh": len(past),
        "analytic": {"axes": first_run["axes"],
                     "equals_measured": (first_run["axes"], first_run["ops"])
                     == (plan["axes"], plan["ops"]),
                     "predicted_step_ms":
                         first_run["predicted_step_us"] / 1e3,
                     "walls_s": [first_run["wall_s"], second_run["wall_s"]],
                     "cache_modes": [first_run["cache_mode"],
                                     second_run["cache_mode"]]},
        "losses": losses, "one_device_losses": train_losses[:3],
        "max_relative_diff_first3": max(rels),
        "launches_per_step": {k: v for k, v in per_step.items()
                              if "/" not in k},
        "ms_per_step_rank0": first["ms_per_step"],
        "ms_per_step_note": "4 ranks time-sharing one card over gloo: "
                            "not a mesh speed",
        "peak_mem_gib_by_rank": [j.get("peak_mem_gib") for j in on_mesh],
        "build_s_by_rank": [j["build_s"] for j in jobs],
        "spawn_wall_s": wall,
        "tolerance": "every rank the same plan; the mesh's ranks the same "
                     "losses; |loss - one device| <= 2e-2 |one device|, "
                     "steps 1-3"}
    launches = {k: int(round(v * counted)) for k, v in per_step.items()
                if "/" not in k and v}
    return record, launches


def _cls_margins(torch, model, x):
    """The classifier's logit gap z1 - z0 per token (min, mean, max) and
    the smallest and largest output probability, through the inference
    walk on the model's current weights."""
    cls = next(op for op in model.ops if op.name == "cls")
    vals = model.executor.forward_values(
        {model.input_ops[0].name: torch.from_numpy(x).to(model.device)})
    z = vals[cls.outputs[0].guid].float()
    p = vals[model.final_tensor.guid].float()
    gap = z[..., 1] - z[..., 0]
    return {"gap_min": float(gap.min()), "gap_mean": float(gap.mean()),
            "gap_max": float(gap.max()), "p_min": float(p.min()),
            "p_max": float(p.max())}


def _train_batch():
    """bench.py `_run`'s batch: tokens and labels from RandomState(0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x = rng.randint(0, TRAIN["vocab"], size=(b, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(b, seq, 1)).astype(np.int32)
    return x, y


def phase_train(torch, warmup=3, steps=10):
    """Full-width training through compile and fit; returns the phase's
    record (launches per step among them) and the initial weights on the
    host. The classifier's margins are read before and after the first
    step (outside the timed and counted steps)."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    selected_before = _selections(TRAIN_FAMILIES)
    t0 = time.perf_counter()
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    build_s = time.perf_counter() - t0
    init = {op: {w: t.cpu().clone() for w, t in ws.items()}
            for op, ws in model.params.items()}
    n_params = sum(t.numel() for ws in init.values() for t in ws.values())
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x, y = _train_batch()
    margins = [_cls_margins(torch, model, x)]
    # fit returns one summary per epoch (one step each here); the per-step
    # losses and times are its StepStats records
    model.fit(x, y, batch_size=b, epochs=1)
    warm = model.step_stats.records()
    margins.append(_cls_margins(torch, model, x))
    model.fit(x, y, batch_size=b, epochs=warmup - 1)
    warm += model.step_stats.records()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    model.fit(x, y, batch_size=b, epochs=steps)
    hist = model.step_stats.records()
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [r["loss"] for r in warm + hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    expected = {**TRAIN_PER_STEP, **TRAIN_ROUTES_PER_STEP}
    wrong = {k: launches[k] / steps for k, n in expected.items()
             if launches[k] != n * steps}
    if wrong:
        raise AssertionError(f"training path launches per step {wrong}, "
                             f"expected {expected}")
    # the registry's auto policy chose the kernels, and never a reference
    # lowering, on the card
    selected = {k: v - selected_before[k]
                for k, v in _selections(TRAIN_FAMILIES).items()}
    if any(selected[(f, "pallas")] <= 0 or selected[(f, "reference")] != 0
           for f in TRAIN_FAMILIES):
        raise AssertionError(f"kernel registry selections on the training "
                             f"path: {selected}")
    step_ms = np.array([r["step_ms"] for r in hist])
    flops = train_step_flops(**TRAIN)
    med_s = float(np.median(step_ms)) / 1e3
    return {
        "phase": "train", "params": n_params, "model_build_s": build_s,
        "batch": b, "seq": seq, "warmup_steps": warmup, "steps": steps,
        "ms_per_step_median": float(np.median(step_ms)),
        "ms_per_step_mean": float(step_ms.mean()),
        "ms_per_step_min": float(step_ms.min()),
        "samples_per_s": b / med_s,
        "flops_per_step": flops,
        "mfu_bf16_peak": flops / med_s / PEAK_OPS_PER_S["bfloat16"],
        "losses": losses,
        "cls_margins_before_after_step1": margins,
        "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in TRAIN_KERNELS},
        "routes_per_step": {k: launches[k] / steps
                            for k in TRAIN_ROUTES_PER_STEP},
        "ff_kernel_selected_total": {f"{f}/{i}": v
                                     for (f, i), v in selected.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }, init


def _k_means(np, losses, k):
    """Per-step losses folded as fit records a K-step dispatch: the f32
    mean of each K in turn (runtime/executor.py MultiStep's metrics,
    reduced by FFModel._absorb)."""
    return [float(np.asarray(losses[i:i + k], np.float32).mean())
            for i in range(0, len(losses), k)]


def _dispatch_losses(model, k):
    """The per-step losses of the model's last K-step dispatch: the
    captured graph's static output (MultiStep.out), which fit's StepStats
    record reduces to their mean."""
    ms = model._multi_step(k)
    return [float(v) for v in ms.out[ms.keys.index("loss")].cpu()]


def _selections(families):
    """ff_kernel_selected_total by (family, impl)."""
    from flexflow_tpu_torch.obs import REGISTRY

    fam = REGISTRY.counter(
        "ff_kernel_selected_total",
        "Kernel-tier selections by op family and implementation",
        labels=("op", "impl"))
    return {(f, i): fam.value(op=f, impl=i) for f in families
            for i in ("pallas", "reference")}


def phase_train_witness(torch, init, bf16_losses, steps=3):
    """The train phase's first steps again from the same weights and
    batch, in f32 on the card and in f32 on the CPU (plain versions):
    per-step losses of the card's f32 run against the CPU's within 1e-3
    relative, and of the train phase's bf16 run (bf16 activations, the
    timed path) against the CPU's within 2e-2, the bf16 tolerance of
    tests/test_torch_train.py. Both also use Adam with bf16 moments."""
    import numpy as np

    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    x, y = _train_batch()
    out = {}
    for name, dev, seed in (("card_f32", "cuda", 3), ("cpu_f32", "cpu", 4)):
        t0 = time.perf_counter()
        m = build_bench_model(dev, TRAIN["layers"], False, seed)
        m.load_params(init)
        margins = [_cls_margins(torch, m, x)]
        m.fit(x, y, batch_size=TRAIN["batch"], epochs=1)
        losses = [r["loss"] for r in m.step_stats.records()]
        margins.append(_cls_margins(torch, m, x))
        m.fit(x, y, batch_size=TRAIN["batch"], epochs=steps - 1)
        losses += [r["loss"] for r in m.step_stats.records()]
        out[name] = {"losses": losses, "cls_margins_before_after_step1":
                     margins, "seconds": time.perf_counter() - t0}
        del m
    worst = {"card_f32": 0.0, "card_bf16": 0.0}
    for name, got, tol in (("card_f32", out["card_f32"]["losses"], 1e-3),
                           ("card_bf16", bf16_losses[:steps], 2e-2)):
        for i, (a, c) in enumerate(zip(got, out["cpu_f32"]["losses"])):
            rel = abs(a - c) / abs(c)
            worst[name] = max(worst[name], rel)
            if not (np.isfinite(a) and rel <= tol):
                raise AssertionError(f"train-witness: step {i + 1} loss "
                                     f"{name} {a} vs cpu_f32 {c}")
    frac0 = float((y == 0).mean())
    return {"phase": "train-witness", "layers": TRAIN["layers"],
            "steps": steps, "card_bf16_losses": bf16_losses[:steps], **out,
            "max_relative_diff": worst,
            "label0_share": frac0,
            # log_softmax of probabilities (p0, p1) = (0, 1) exactly
            "loss_if_sure_of_class": {
                c: float(np.log1p(np.exp(-1.0)) + (frac0 if c else 1 - frac0))
                for c in (0, 1)},
            "tolerance": "|loss - cpu_f32| <= 1e-3 |cpu_f32| (card_f32), "
                         "2e-2 |cpu_f32| (card_bf16), each step"}


def _cross_batch():
    import numpy as np

    rng = np.random.RandomState(5)
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x = rng.randint(0, TRAIN["vocab"], size=(b, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(b, seq, 1)).astype(np.int32)
    return x, y


def _two_steps(torch, m, x, y, layers):
    """Loss and six gradient norms of two steps of model `m`, one Adam
    update (bf16 moments) between them."""
    gstep = m.executor.build_grad_metrics_step(m.loss.fn, m.metrics,
                                               m.final_tensor)
    inputs = {m.input_ops[0].name: torch.from_numpy(x).to(m.device)}
    label = torch.from_numpy(y).to(m.device)
    out = []
    for step in (1, 2):
        grads, mvals = gstep(inputs, label)
        norms = {f"{op}/{w}": float(grads[op][w].float().norm())
                 for op, w in (("tok_emb", "weight"),
                               ("layer0_attn", "wq"),
                               ("layer0_attn", "wv"),
                               ("layer0_ln1", "gamma"),
                               (f"layer{layers - 1}_ln2", "beta"),
                               ("cls", "kernel"))}
        out.append({"step": step, "loss": float(mvals["loss"]),
                    "grad_norms": norms})
        if step == 1:
            m.optimizer.update(m.executor.parameters(), grads, m.opt_state)
    return out


def _compare_steps(phase, got, want, names, tol):
    """Worst relative difference of loss and norms, step by step; raises
    past `tol` or on a non-finite value."""
    import numpy as np

    worst = 0.0
    for a_rec, b_rec in zip(got, want):
        checks = {"loss": (a_rec["loss"], b_rec["loss"])}
        checks.update({k: (v, b_rec["grad_norms"][k])
                       for k, v in a_rec["grad_norms"].items()})
        for k, (a, c) in checks.items():
            if not np.isfinite(a):
                raise AssertionError(f"{phase}: non-finite {k} ({names[0]}) "
                                     f"at step {a_rec['step']}")
            rel = abs(a - c) / max(abs(c), 1e-30)
            worst = max(worst, rel)
            if rel > tol:
                raise AssertionError(
                    f"{phase}: step {a_rec['step']} {k} {names[0]} {a} vs "
                    f"{names[1]} {c} (relative {rel})")
    return worst


def phase_train_cross(torch, layers=2):
    """Loss and gradient norms of the first two steps, card vs CPU, f32,
    same weights and batch; between them one Adam update (bf16 moments)
    on each side. Each side under auto: the kernels on the card, the
    reference lowerings on the CPU."""
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    gpu = build_bench_model("cuda", layers, False, 1)
    cpu = build_bench_model("cpu", layers, False, 2)
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in gpu.params.items()})
    x, y = _cross_batch()
    out = {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        out[name] = _two_steps(torch, m, x, y, layers)
    worst = _compare_steps("train-cross", out["card"], out["cpu"],
                           ("card", "cpu"), 1e-3)
    return {"phase": "train-cross", "layers": layers, "dtype": "float32",
            "optimizer": "Adam alpha 1e-4, bf16 moments",
            "card": out["card"], "cpu": out["cpu"],
            "max_relative_diff": worst,
            "tolerance": "|card - cpu| <= 1e-3 |cpu| (loss and each norm, "
                         "steps 1 and 2)"}


def phase_ref_vs_kernel(torch, layers=2):
    """The flagship at `layers` layers, f32, on the card: two steps (one
    Adam update between) under kernel_impl="pallas" — flash attention,
    the CUDA LayerNorm, softmax and reduction — and under "reference" —
    the einsum core and the reference lowerings — from the same weights
    and batch. Each model is compiled just before its steps: the loss
    reduction reads the knob of the last compile."""
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    x, y = _cross_batch()
    out, launches = {}, {}
    for impl in ("pallas", "reference"):
        m = build_bench_model("cuda", layers, False, 1, kernel_impl=impl)
        torch.cuda.synchronize()
        reset_launch_counts()
        out[impl] = _two_steps(torch, m, x, y, layers)
        torch.cuda.synchronize()
        launches[impl] = launch_counts()
        del m
    missing = [k for k in TRAIN_KERNELS if launches["pallas"][k] == 0]
    ran = {k: n for k, n in launches["reference"].items() if n}
    if missing or ran:
        raise AssertionError(f"ref-vs-kernel: kernels not launched under "
                             f"pallas {missing}, launched under reference "
                             f"{ran}")
    worst = _compare_steps("ref-vs-kernel", out["pallas"], out["reference"],
                           ("pallas", "reference"), 1e-3)
    return {"phase": "ref-vs-kernel", "layers": layers, "dtype": "float32",
            "optimizer": "Adam alpha 1e-4, bf16 moments",
            "pallas": out["pallas"], "reference": out["reference"],
            "launches_pallas": launches["pallas"],
            "max_relative_diff": worst,
            "tolerance": "|pallas - reference| <= 1e-3 |reference| (loss "
                         "and each norm, steps 1 and 2)"}


def phase_tier(torch, steps=3):
    """The kernel-tier graph for `steps` fit steps (one batch each, data
    from RandomState(8)): on the card in bf16 under kernel_impl="pallas"
    and "reference", and on the CPU in f32 (the witness). Launches per
    step under pallas exactly TIER_PER_STEP, none under reference; losses
    within 2e-2 relative of each other and of the witness at every step."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_tier_model

    rng = np.random.RandomState(8)
    b = TRAIN["batch"]
    x = rng.randn(steps * b, TRAIN["seq"], TRAIN["hidden"]).astype(
        np.float32)
    y = rng.randint(0, 10, size=(steps * b, TRAIN["seq"], 1)).astype(
        np.int32)
    out = {}
    for name, device, mixed, impl in (
            ("card_pallas_bf16", "cuda", True, "pallas"),
            ("card_reference_bf16", "cuda", True, "reference"),
            ("cpu_f32", "cpu", False, "auto")):
        m = build_tier_model(device, mixed, impl)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        epoch = m.fit(x, y, batch_size=b, epochs=1)
        hist = m.step_stats.records()  # `steps` steps in the one epoch
        torch.cuda.synchronize()
        out[name] = {"losses": [r["loss"] for r in hist],
                     "accuracy": epoch[0]["accuracy"],
                     "launches": launch_counts(),
                     "seconds": time.perf_counter() - t0}
        del m
    got = out["card_pallas_bf16"]["launches"]
    expected = {**TIER_PER_STEP, **TIER_ROUTES_PER_STEP}
    wrong = {k: got[k] for k, n in expected.items() if got[k] != n * steps}
    extra = {k: n for k, n in got.items() if n and k not in expected}
    ran = {k: n for k, n in out["card_reference_bf16"]["launches"].items()
           if n}
    if wrong or extra or ran:
        raise AssertionError(f"tier: launches under pallas {wrong} {extra} "
                             f"(expected {expected} per step), under "
                             f"reference {ran}")
    worst = {}
    for a, c in (("card_pallas_bf16", "card_reference_bf16"),
                 ("card_pallas_bf16", "cpu_f32"),
                 ("card_reference_bf16", "cpu_f32")):
        rels = [abs(p - q) / abs(q) for p, q in zip(out[a]["losses"],
                                                      out[c]["losses"])]
        worst[f"{a} vs {c}"] = max(rels)
        if len(rels) != steps or not all(np.isfinite(out[a]["losses"])) \
                or max(rels) > 2e-2:
            raise AssertionError(f"tier: losses {a} {out[a]['losses']} vs "
                                 f"{c} {out[c]['losses']}")
    return {"phase": "tier", "shape": [b, TRAIN["seq"], TRAIN["hidden"]],
            "steps": steps, **out,
            "launches_per_step_pallas": {k: got[k] / steps
                                         for k in expected},
            "max_relative_diff": worst,
            "tolerance": "|loss - other| <= 2e-2 |other| at every step"}


def phase_train_graph(torch):
    """The train phase's flagship, from the same initial weights (the
    seed-0 generator) and batch: GRAPH_STEPS steps through
    fit(steps_per_execution=GRAPH_K) (a CUDA graph of GRAPH_K captured
    steps) against as many eager steps; every step's loss and every
    final weight the same bits. Launches counted from 0 before the
    graphed fit: the first dispatch's GRAPH_K steps run eagerly (the
    warm-up) and are captured once, the replays launch nothing from the
    host, so each kernel counts 2 x GRAPH_K x its launches a step. Then
    host wall, device busy and idle a step for K = 1 eager and K =
    GRAPH_K graphed (tools/train_profile.py profile_fit), peak memory of
    each run, MFU."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model, \
        profile_fit

    b, k, n = TRAIN["batch"], GRAPH_K, GRAPH_STEPS
    x, y = _train_batch()
    xs, ys = np.concatenate([x] * n), np.concatenate([y] * n)
    flops = train_step_flops(**TRAIN)
    runs = {}
    for name, steps_per_execution in (("eager", 1), ("graph", k)):
        model = build_bench_model("cuda", TRAIN["layers"], True, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        model.fit(xs, ys, batch_size=b, epochs=1,
                  steps_per_execution=steps_per_execution)
        torch.cuda.synchronize()
        launches = launch_counts()
        recs = model.step_stats.records()
        # a record a step, or a K-step dispatch's f32 mean loss
        losses = [r["loss"] for r in recs]
        run = {"losses": losses, "records": len(recs),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {kk: launches[kk] for kk in TRAIN_PER_STEP}}
        weights = {f"{op}/{w}": t.detach().cpu()
                   for op, ws in model.params.items() for w, t in ws.items()}
        prof = profile_fit(model, x, y, b, 3 * k, steps_per_execution)
        med = prof["wall_ms_per_step"] / 1e3
        run.update(prof, mfu_bf16_peak=flops / med /
                   PEAK_OPS_PER_S["bfloat16"])
        run.pop("kernels")
        runs[name] = (run, weights)
        del model
        torch.cuda.empty_cache()
    (eager, w_eager), (graph, w_graph) = runs["eager"], runs["graph"]
    if len(eager["losses"]) != n or len(graph["losses"]) != n // k \
            or not all(np.isfinite(graph["losses"])):
        raise AssertionError(f"train-graph: losses {eager['losses']} vs "
                             f"{graph['losses']}")
    # each dispatch's record against the f32 mean of the same K eager
    # steps (MultiStep's reduction)
    diff = max(abs(a - c) / abs(c) for a, c in zip(
        graph["losses"], _k_means(np, eager["losses"], k)))
    same_weights = all(torch.equal(w_graph[kk], t)
                       for kk, t in w_eager.items())
    if diff != 0.0 or not same_weights:
        raise AssertionError(f"train-graph: the graphed steps differ from "
                             f"the eager ones (loss rel diff {diff}, "
                             f"weights equal: {same_weights})")
    wrong = {kk: graph["launches"][kk] for kk, per in TRAIN_PER_STEP.items()
             if graph["launches"][kk] != 2 * k * per}
    if wrong or eager["launches"]["optimizer_adam"] != n:
        raise AssertionError(f"train-graph: launches {wrong} (expected "
                             f"2 x {k} x {TRAIN_PER_STEP}), eager "
                             f"{eager['launches']}")
    return {"phase": "train-graph", "steps": n, "steps_per_execution": k,
            "eager": eager, "graph": graph,
            "max_relative_loss_diff": diff, "weights_same_bits": True,
            "tolerance": "each dispatch's mean loss (the eager steps' f32 "
                         "mean over the same K) and the final weights "
                         "equal to the bit (the same kernels in the same "
                         "order)",
            "ms_per_step_median": {"eager_k1": eager["ms_per_step_median"],
                                   f"graph_k{k}": graph["ms_per_step_median"]},
            "flops_per_step": flops}


def _synthetic(n=2048, dim=64, classes=10, seed=0):
    """tests/test_mnist_mlp.py `make_synthetic`: a learnable linear task
    from seeded numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)[:, None]


def phase_mlp(torch, epochs=12):
    """The digits gate's MLP (64 -> 128 -> 64 -> 10, RELU, softmax, Adam
    2e-3, batch 64) on make_synthetic's data, on the card: trained eagerly
    and with steps_per_execution=4 from the same weights (every epoch's
    loss within 1e-6 relative: the same steps, the epoch summing a
    dispatch's f32 mean for its four losses), with accum_steps=2 and
    through attached dataloaders (shuffled); each ends with eval accuracy
    > 0.9 on the first 512 samples. Launches per step of the eager run
    asserted (MLP_PER_STEP). Then eval, fit, eval, fit, eval (eager, then
    K=4): each eval after a fit equal to a fresh model's given the
    trained weights."""
    import numpy as np

    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, MetricsType, SingleDataLoader)
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts

    x, y = _synthetic()
    bs = 64

    def build():
        m = FFModel(FFConfig(batch_size=bs, device="cuda"))
        t = m.create_tensor([bs, 64])
        t = m.dense(t, 128, ActiMode.AC_MODE_RELU)
        t = m.dense(t, 64, ActiMode.AC_MODE_RELU)
        m.softmax(m.dense(t, 10))
        # weights from compile's default generator (seed 0)
        m.compile(optimizer=AdamOptimizer(m, alpha=2e-3),
                  metrics=[MetricsType.METRICS_ACCURACY,
                           MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
        return m

    out = {}
    for name, kw in (("eager", {}), ("k4", {"steps_per_execution": 4}),
                     ("accum2", {"accum_steps": 2}), ("dataloader", {})):
        m = build()
        if name == "dataloader":
            SingleDataLoader(m, m.input_ops[0].outputs[0], x, shuffle=True,
                             seed=5)
            SingleDataLoader(m, m.label_tensor, y, shuffle=True, seed=5)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = m.fit(None if name == "dataloader" else x,
                     None if name == "dataloader" else y, epochs=epochs,
                     **kw)
        torch.cuda.synchronize()
        launches = launch_counts()
        ev = m.eval(x[:512], y[:512])
        out[name] = {"losses": [h["loss"] for h in hist],
                     "train_accuracy": hist[-1]["accuracy"],
                     "eval": ev, "seconds": time.perf_counter() - t0,
                     "optimizer_steps": int(m.opt_state["step"]),
                     "launches": {kk: launches[kk] for kk in MLP_PER_STEP}}
        if not (ev["accuracy"] > 0.9 and np.all(np.isfinite(
                out[name]["losses"]))):
            raise AssertionError(f"mlp {name}: {out[name]}")
        del m
    steps = epochs * (len(x) // bs)
    wrong = {kk: out["eager"]["launches"][kk] for kk, per in
             MLP_PER_STEP.items()
             if out["eager"]["launches"][kk] != per * steps}
    diff = max(abs(a - c) / abs(c) for a, c in zip(out["k4"]["losses"],
                                                    out["eager"]["losses"]))
    if wrong or diff > 1e-6 or out["accum2"]["optimizer_steps"] != steps // 2:
        raise AssertionError(f"mlp: launches {wrong} (expected "
                             f"{MLP_PER_STEP} x {steps}), K=4 vs eager loss "
                             f"rel diff {diff}, accum2 "
                             f"{out['accum2']['optimizer_steps']} steps")
    # eval, fit, eval, fit, eval: the bf16 casts of the weights that eval
    # reads are cached by weight version (core/op.py Op.w); the update
    # kernel and a graph replay write the weights through raw pointers
    # and bump the versions, so each eval after a fit equals a fresh
    # model's given the trained weights. K=4 over 12 steps: the first fit
    # one captured dispatch and two replays, the second replays only
    refit = {}
    xs, ys, xe, ye = x[:bs * 12], y[:bs * 12], x[:512], y[:512]
    for name, k in (("eager", 1), ("k4", 4)):
        m = build()
        losses = [m.eval(xe, ye)["loss"]]
        for _ in range(2):
            m.fit(xs, ys, epochs=1, steps_per_execution=k)
            after = m.eval(xe, ye)
            fresh = build()
            fresh.load_params(m.params)
            want = fresh.eval(xe, ye)
            if after != want or after["loss"] == losses[-1]:
                raise AssertionError(
                    f"mlp eval-fit-eval ({name}): eval after fit {after}, "
                    f"a fresh model with the trained weights {want}, eval "
                    f"losses before {losses}")
            losses.append(after["loss"])
            del fresh
        refit[name] = {"eval_losses": losses}
        del m
    return {"phase": "mlp", "epochs": epochs, "batch": bs, **out,
            "k4_vs_eager_max_relative_loss_diff": diff,
            "eval_fit_eval": refit,
            "tolerance": "eval accuracy > 0.9 each; K=4 epoch losses within "
                         "1e-6 relative of the eager run's; each eval after a "
                         "fit equal in every key to a fresh model's"}


def _walk_launches(torch, fn):
    """The kernel launches of one call of fn (a walk), by kernel."""
    from flexflow_tpu_torch.kernels import launch_counts

    before = launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in launch_counts().items()
            if n > before[k] and "/" not in k}


# the device kernels of each serving wrapper, by symbol (a decode call
# launches the split kernel, counted here, then the combine)
SERVE_SYMBOLS = {
    "decode_attention": ("decode_tc_kernel", "decode_cc_kernel"),
    "multiquery_decode_attention": ("decode_tc_kernel", "decode_cc_kernel"),
    "layernorm_fwd": ("layernorm_fwd_warp_kernel", "layernorm_fwd_kernel"),
    "softmax_fwd": ("softmax_rows_kernel", "softmax_regs_kernel",
                    "softmax_loop_kernel"),
}


def _device_kernels(torch, fn, reps):
    """The device kernels (not copies) of one call of fn, by name, as
    torch.profiler sees them over `reps` calls (in a session padded with
    idle time, where it drops no record: tools/trace_edges.py)."""
    from collections import Counter

    from torch.autograd import DeviceType

    from flexflow_tpu_torch.tools.serve_profile import trace_device

    with trace_device(cpu=False) as prof:
        for _ in range(reps):
            fn()
    seen = Counter(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset")))
    return {name: n / reps for name, n in seen.items()}


def phase_serve_graph(torch, lm, max_len, page, iters=20, reps=3):
    """One decode iteration (8 slots, ragged positions) and one prefill
    chunk (slot 3 at 480) of the serve LM, through the eager walk and
    through a CUDA graph replay, on the same caches and inputs: the
    probabilities, the picked tokens and every cache row the same bits
    (the same kernels in the same order). The launches of one eager walk
    of each (the wrappers' counts); the device kernels of a replay, seen
    by the profiler over `reps` replays, equal to those of an eager walk,
    and each serving kernel's among them equal to the walk's launches (a
    replay runs no wrapper, so this is what shows the timed serve run's
    replays run the serving kernels). Also the host wall of a dispatch
    each way."""
    import re

    import numpy as np

    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    cb = ContinuousBatcher(lm, max_len=max_len, num_slots=8,
                           page_size=page, prefix_cache_pages=0)
    g = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.RandomState(7)
    dec = np.concatenate([rng.randint(0, 30522, size=8),
                          [40, 97, 255, 300, 511, 700, 880, 1000],
                          np.zeros(8)]).astype(np.int32)
    chunk = np.append(rng.randint(0, 30522, size=page), 480).astype(np.int32)

    def snap():
        return [t.clone() for c in cb._caches.values() for t in c.values()]

    def restore(saved):
        for t, v in zip((t for c in cb._caches.values()
                         for t in c.values()), saved):
            t.copy_(v)

    def eager_decode():
        cb._dec_in.put(dec)
        cb._decode_walk()
        return cb._dec_tok.cpu().numpy()

    def eager_chunk():
        cb._chunk_in.put(chunk)
        cb._chunk_walk(3)()

    with torch.no_grad():
        for c in cb._caches.values():
            for t in c.values():
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        saved = snap()
        walk = {"decode": _walk_launches(torch, eager_decode),
                "chunk": _walk_launches(torch, eager_chunk)}
        restore(saved)
        cb._decode_dispatch(dec)   # warm-up and capture
        cb._chunk_dispatch(3, chunk)
        runs = []
        for replay in (True, False):
            restore(saved)
            toks = cb._decode_dispatch(dec) if replay else eager_decode()
            dprobs = cb._dec_probs.clone()
            if replay:
                cb._chunk_dispatch(3, chunk)
            else:
                eager_chunk()
            runs.append((toks, dprobs, cb._chunk_probs.clone(), snap()))
        (t0, d0, c0, k0), (t1, d1, c1, k1) = runs
        same = {"tokens": bool(np.array_equal(t0, t1)),
                "decode_probs": bool(torch.equal(d0, d1)),
                "chunk_probs": bool(torch.equal(c0, c1)),
                "cache_rows": all(torch.equal(a, b) for a, b in zip(k0, k1))}
        if not all(same.values()):
            raise AssertionError(f"graph replay vs eager walk: {same}")
        replay_launches = {}
        for which, eager, replay in (
                ("decode", eager_decode, lambda: cb._decode_dispatch(dec)),
                ("chunk", eager_chunk, lambda: cb._chunk_dispatch(3, chunk))):
            walked = _device_kernels(torch, eager, reps)
            replayed = _device_kernels(torch, replay, reps)
            if walked != replayed:
                diff = {k: (walked.get(k, 0), replayed.get(k, 0))
                        for k in set(walked) | set(replayed)
                        if walked.get(k, 0) != replayed.get(k, 0)}
                raise AssertionError(f"{which}: device kernels (walk, "
                                     f"replay) differ: {diff}")
            replay_launches[which] = {
                k: sum(n for name, n in replayed.items() if re.search(
                    r"\b(%s)\b" % "|".join(SERVE_SYMBOLS[k]), name))
                for k in walk[which] if k in SERVE_SYMBOLS}
            off = {k: (walk[which][k], n)
                   for k, n in replay_launches[which].items()
                   if n != walk[which][k]}
            if off or not replay_launches[which]:
                raise AssertionError(f"{which}: a replay's serving kernels "
                                     f"(walk launches, replay kernels): "
                                     f"{off or replay_launches[which]}")
            replay_launches[which]["device_kernels"] = sum(replayed.values())
        wall = {}
        for name, fn in (("decode_graph", lambda: cb._decode_dispatch(dec)),
                         ("decode_eager", eager_decode),
                         ("chunk_graph", lambda: (cb._chunk_dispatch(
                             3, chunk), cb._chunk_probs[0, -1].argmax()
                             .cpu())),
                         ("chunk_eager", lambda: (eager_chunk(),
                                                  cb._chunk_probs[0, -1]
                                                  .argmax().cpu()))):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            wall[name] = (time.perf_counter() - t) / iters * 1e3
    graphs = dict(cb.graphs)
    del cb, saved, runs
    return {"phase": "serve-graph", "same_bits": same,
            "walk_launches": walk, "replay_launches": replay_launches,
            "host_wall_ms_per_dispatch": wall, "graphs": graphs}


def phase_generate(torch, lm, vocab, new=64):
    """GenerativeSession on the serve LM at full width (batch 8, window
    512, max_len 1024): 8 prompts of one length drawn from [32, 512],
    greedy at tokens_per_dispatch 1 and 8, each three times (the first
    call captures the graphs of 8 steps and of the ragged 7, the second
    makes the first replay of the latter, which uploads it): the same
    tokens; the host wall of the third call. Then three calls of one new
    token: the prefill and the first pick alone (the third timed). Every
    launch of the phase is the session's own: each generate call prefills
    through the causal flash forward, one launch a layer on the tensor
    cores."""
    import numpy as np

    from flexflow_tpu_torch.ffconst import OpType
    from flexflow_tpu_torch.kernels import launch_counts
    from flexflow_tpu_torch.serving import GenerativeSession

    layers = sum(op.op_type == OpType.MULTIHEAD_ATTENTION
                 for op in lm.graph.ops.values())
    rng = np.random.RandomState(5)
    plen = int(rng.randint(32, 513))
    prompts = rng.randint(0, vocab, size=(8, plen)).astype(np.int32)
    s = GenerativeSession(lm, max_len=1024)
    calls = 0
    runs = {}
    for k, n in ((1, new), (8, new), (1, 1)):
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks = s.generate(prompts, n, tokens_per_dispatch=k)
            runs[k, n] = (toks, (time.perf_counter() - t) * 1e3)
            calls += 1
    if runs[1, new][0].shape != (8, new) or not np.array_equal(
            runs[1, new][0], runs[8, new][0]):
        raise AssertionError("session tokens differ between "
                             "tokens_per_dispatch 1 and 8")
    if not np.array_equal(runs[1, 1][0], runs[1, new][0][:, :1]):
        raise AssertionError("a one-token call's token differs from the "
                             "first of a longer call's")
    if runs[1, new][0].min() < 0 or runs[1, new][0].max() >= vocab:
        raise AssertionError("session token out of range")
    counts = launch_counts()
    flash = {"flash_fwd": counts["flash_fwd"],
             "flash_fwd/tc": counts["flash_fwd/tc"]}
    if flash != {"flash_fwd": layers * calls,
                 "flash_fwd/tc": layers * calls}:
        raise AssertionError(f"the session's {calls} generate calls "
                             f"launched {flash}, expected {layers} a call "
                             f"on the tensor cores")
    prefill = runs[1, 1][1]
    graphs = dict(s.counts)
    del s
    return {"phase": "generate", "prompt_len": plen, "new_tokens": new,
            "tokens_identical_k1_k8": True, "generate_calls": calls,
            "flash_fwd_launches": flash,
            "wall_ms": {f"k={k}": runs[k, new][1] for k in (1, 8)},
            "ms_per_token": {f"k={k}": runs[k, new][1] / new
                             for k in (1, 8)},
            # host walls of the session's own calls: a one-token call
            # (prefill and first pick), and the rest of a 64-token call
            "prefill_ms": prefill,
            "decode_ms_per_token": {f"k={k}": (runs[k, new][1] - prefill)
                                    / (new - 1) for k in (1, 8)},
            "graphs": graphs}


def phase_oneshot(torch, lm, max_len, page, prompts, news, chunked):
    """The serve mix's first 8 requests under prefill_chunk_tokens=0 (one
    full-sequence walk a request fills the slot's caches, the flash
    forward causal at b = 1): greedy agreement with the chunked run's
    tokens (reported; bf16 at 12 layers may break near-ties otherwise)
    and TTFT."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    with ContinuousBatcher(lm, max_len=max_len, num_slots=8,
                           page_size=page, prefill_chunk_tokens=0) as cb:
        cb.submit(np.arange(1, 41, dtype=np.int32), 4).result(timeout=600)
        t0 = time.perf_counter()
        reqs = [cb.submit(p, n) for p, n in zip(prompts, news)]
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        stats = cb.stats()
    for out, n in zip(outs, news):
        if len(out) != n:
            raise AssertionError(f"one-shot request: {len(out)} tokens, "
                                 f"expected {n}")
    agree = [int(np.argmax(np.append(a != b, True))) for a, b in
             zip(outs, chunked)]
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    return {"phase": "oneshot", "requests": len(reqs),
            "identical_requests": sum(bool(np.array_equal(a, b))
                                      for a, b in zip(outs, chunked)),
            "leading_tokens_equal": agree, "new_tokens": news,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "tokens_per_s": sum(map(len, outs)) / wall,
            "graphs": stats["graphs"], "prefill_chunks":
            stats["prefill_chunks"]}


def phase_prefix(torch, lm, max_len, page, vocab):
    """make_shared_prefix_workload(16, 4, 128, 2, 8, 32, 64, vocab, seed 0)
    (the JAX serve-bench's shared-prefix defaults), leaders first, then
    followers, through the default batcher (prefix cache on) and one with
    prefix_cache_pages=0: hits and pages saved, every follower's greedy
    tokens the cold run's bits, TTFT of hits and misses."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched import (
        ContinuousBatcher, make_shared_prefix_workload)

    work = make_shared_prefix_workload(16, 4, 128, 2, 8, 32, 64, vocab, 0)

    def run(pages):
        with ContinuousBatcher(lm, max_len=max_len, num_slots=8,
                               page_size=page, prefix_cache_pages=pages,
                               max_queue=32) as cb:
            # zeros never occur in the workload (ids from [1, vocab))
            warm = [cb.submit(np.zeros(40, np.int32), 4) for _ in range(8)]
            for r in warm:
                r.result(timeout=600)
            lead = [cb.submit(w["prompt"], w["max_new"])
                    for w in work if w["leader"]]
            for r in lead:
                r.result(timeout=900)
            foll = [cb.submit(w["prompt"], w["max_new"])
                    for w in work if not w["leader"]]
            for r in foll:
                r.result(timeout=900)
            return lead, foll, cb.stats()

    lead, foll, stats = run(None)
    _, cold_foll, cold_stats = run(0)
    prefix = stats["pool"]["prefix"]
    if prefix["hits"] == 0 or prefix["pages_saved"] == 0:
        raise AssertionError(f"no prefix-cache hits: {prefix}")
    same = [bool(np.array_equal(a.result(), b.result()))
            for a, b in zip(foll, cold_foll)]
    if not all(same):
        raise AssertionError(f"followers' tokens differ from the cold "
                             f"run's: {same}")
    hit = [r.ttft_s * 1e3 for r in foll if r.cache_hit]
    miss = [r.ttft_s * 1e3 for r in lead]
    cold = [r.ttft_s * 1e3 for r in cold_foll]
    return {"phase": "prefix", "requests": len(work),
            "followers_hit": sum(r.cache_hit for r in foll),
            "followers_identical_to_cold": True, "prefix": prefix,
            "prefill_chunks": stats["prefill_chunks"],
            "prefill_chunks_cold": cold_stats["prefill_chunks"],
            "ttft_ms_hit_p50": float(np.percentile(hit, 50)),
            "ttft_ms_miss_p50": float(np.percentile(miss, 50)),
            "ttft_ms_cold_followers_p50": float(np.percentile(cold, 50)),
            "graphs": stats["graphs"]}


def _spec_serve(torch, lm, draft, max_len, page, vocab, prompts, news):
    """The serve phase's run through ContinuousBatcher(draft_model=draft,
    spec_tokens=3): 8 warm-up requests (one a slot: every chunk graph of
    both models and the speculative graph captured), then the serve
    phase's 16 requests, timed. Returns the batcher (stopped), its
    requests, tokens, wall and the graph and spec counts before the timed
    run."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    cb = ContinuousBatcher(lm, max_len=max_len, num_slots=8,
                           page_size=page, draft_model=draft,
                           spec_tokens=SPEC_TOKENS)
    cb.start()
    try:
        warm_rng = np.random.RandomState(2)
        warm = [cb.submit(warm_rng.randint(0, vocab, size=40), 4)
                for _ in range(8)]
        for r in warm:
            r.result(timeout=600)
        before = cb.stats()
        t0 = time.perf_counter()
        reqs = [cb.submit(p, int(n)) for p, n in zip(prompts, news)]
        outs = [r.result(timeout=900) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cb.stop()
    return cb, reqs, outs, wall, before


def _spec_f32(torch, vocab, max_len, page):
    """The spec identities in f32 at 2 layers (full widths): greedy tokens
    of 4 requests through the speculative batcher on the card (an untied
    1-layer draft, and the target as its own draft) equal the card's plain
    greedy tokens and the CPU's speculative run's (untied draft)."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    def lm(layers, seed, device):
        return build_tiny_lm(4, 512, vocab=vocab, hidden=1024, heads=16,
                             layers=layers, mixed_precision=False,
                             device=device,
                             generator=torch.Generator().manual_seed(seed))

    target, draft = lm(2, 3, "cuda"), lm(1, 4, "cuda")
    cpu_target, cpu_draft = lm(2, 3, "cpu"), lm(1, 4, "cpu")
    rng = np.random.RandomState(6)
    work = [(rng.randint(0, vocab, size=n).astype(np.int32), 24)
            for n in (23, 40, 77, 100)]

    def run(model, d):
        with ContinuousBatcher(model, max_len=max_len, num_slots=4,
                               page_size=page, draft_model=d,
                               spec_tokens=SPEC_TOKENS) as cb:
            reqs = [cb.submit(p, n) for p, n in work]
            toks = [r.result(timeout=900).tolist() for r in reqs]
        return toks, cb.stats().get("spec")

    def _counts(st):
        # per-request sums; the EWMA also depends on which requests share
        # an iteration, which admission timing decides
        return {k: st[k] for k in ("proposed", "accepted", "acceptance")}

    plain, _ = run(target, None)
    untied, st_untied = run(target, draft)
    tied, st_tied = run(target, target)
    cpu, st_cpu = run(cpu_target, cpu_draft)
    same = {"card_untied_vs_card_plain": untied == plain,
            "card_tied_vs_card_plain": tied == plain,
            "cpu_untied_vs_card_plain": cpu == plain,
            "untied_spec_counts_card_vs_cpu": _counts(st_untied)
            == _counts(st_cpu)}
    if not all(same.values()):
        raise AssertionError(f"f32 speculative identities: {same}")
    return {"requests": len(work), "new_tokens": 24, "identical": same,
            "acceptance": {"untied": st_untied["acceptance"],
                           "tied": st_tied["acceptance"]}}


def phase_spec(torch, lm, max_len, page, vocab, prompts, news, plain_outs,
               serve, reps=10):
    """Speculative decoding on the serve LM (phase 20): the serve mix
    through a tied draft (the LM itself) and an untied one (2 layers at
    the same widths, its own generator); every request whole, the timed
    runs only replaying graphs, the tied draft's acceptance >= 0.8 in
    bf16, and (printed) how many requests give the plain run's tokens.
    On the tied batcher: one iteration's replay against its eager walk
    (picks, counts, probabilities, both models' cache rows the same
    bits), the launches of one walk, each pick the argmax of its verify
    row, the host wall and the device busy time of an iteration. Then the
    f32 identities (`_spec_f32`)."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
    from flexflow_tpu_torch.tools.serve_profile import (_kernel_table,
                                                        trace_device)

    untied = build_tiny_lm(8, 512, vocab=vocab, hidden=1024, heads=16,
                           layers=2, mixed_precision=True, device="cuda",
                           generator=torch.Generator().manual_seed(1))
    out = {"phase": "spec", "spec_tokens": SPEC_TOKENS,
           "plain": {k: serve[k] for k in ("tokens_per_s", "ttft_ms_p50",
                                           "ttft_ms_p99")}}
    k = SPEC_TOKENS
    for name, draft in (("tied", lm), ("untied", untied)):
        cb, reqs, outs, wall, before = _spec_serve(
            torch, lm, draft, max_len, page, vocab, prompts, news)
        stats = cb.stats()
        timed = {g: n - before["graphs"][g]
                 for g, n in stats["graphs"].items()}
        if (timed["replays"] == 0 or any(
                timed[g] for g in ("warmups", "captures", "eager_walks"))
                or before["graphs"]["eager_walks"]):
            raise AssertionError(f"spec {name}: the timed run must only "
                                 f"replay graphs (warm-up "
                                 f"{before['graphs']}, timed {timed})")
        for r, o, n in zip(reqs, outs, news):
            if len(o) != int(n) or o.min() < 0 or o.max() >= vocab:
                raise AssertionError(f"spec {name}: request {r.id}: "
                                     f"{len(o)} tokens, expected {int(n)}")
        proposed = stats["spec"]["proposed"] - before["spec"]["proposed"]
        accepted = stats["spec"]["accepted"] - before["spec"]["accepted"]
        acceptance = accepted / proposed if proposed else 0.0
        if name == "tied" and acceptance < 0.8:
            raise AssertionError(f"tied draft's bf16 acceptance "
                                 f"{acceptance} < 0.8")
        ttft = np.array([r.ttft_s for r in reqs]) * 1e3
        generated = int(sum(len(o) for o in outs))
        iters = stats["decode_iterations"] - before["decode_iterations"]
        row = {"tokens_per_s": generated / wall, "wall_s": wall,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p99": float(np.percentile(ttft, 99)),
               "acceptance": acceptance, "proposed": proposed,
               "accepted": accepted, "spec_iterations": iters,
               "iteration_ms_mean": stats["decode_iter_s_mean"] * 1e3,
               "identical_to_plain_bf16": sum(
                   bool(np.array_equal(a, b))
                   for a, b in zip(outs, plain_outs)),
               "graphs_warmup": before["graphs"], "graphs_timed": timed}
        # one iteration at ragged positions, the last slot at the edge
        rng = np.random.RandomState(9)
        host = np.concatenate([rng.randint(0, vocab, size=8),
                               [40, 97, 255, 300, 511, 700, 880, 1020]]
                              ).astype(np.int32)
        caches = [t for c in (cb._caches, cb._draft_caches)
                  for d in c.values() for t in d.values()]
        with torch.no_grad():
            saved = [t.clone() for t in caches]
            runs = []
            for replay in (True, False):
                for t, v in zip(caches, saved):
                    t.copy_(v)
                if replay:
                    got = cb._spec_dispatch(host)
                else:
                    cb._spec_in.put(host)
                    cb._spec_walk()
                    got = cb._spec_out.cpu().numpy()
                runs.append((got, cb._spec_probs.clone(),
                             [t.clone() for t in caches]))
            (o0, p0, c0), (o1, p1, c1) = runs
            same = {"picks_counts": bool(np.array_equal(o0, o1)),
                    "verify_probs": bool(torch.equal(p0, p1)),
                    "cache_rows": all(torch.equal(a, b)
                                      for a, b in zip(c0, c1))}
            if not all(same.values()):
                raise AssertionError(f"spec {name}: replay vs eager walk: "
                                     f"{same}")
            argmax = cb._spec_probs.argmax(dim=-1)[:, :k].cpu().numpy()
            if not np.array_equal(argmax, o1[:, :k]):
                raise AssertionError(f"spec {name}: a pick is not the "
                                     "argmax of its verify row")
            for t, v in zip(caches, saved):
                t.copy_(v)
            walk = _walk_launches(torch, lambda: (cb._spec_in.put(host),
                                                  cb._spec_walk()))
            layers = lambda m: sum(  # noqa: E731
                op.op_type.value == "multihead_attention"
                for op in m.graph.ops.values())
            want = {"multiquery_decode_attention": layers(lm),
                    "decode_attention": k * layers(draft)}
            if {n: walk.get(n, 0) for n in want} != want:
                raise AssertionError(f"spec {name}: one walk launched "
                                     f"{walk}, expected {want}")
            cb._spec_dispatch(host)
            with trace_device(cpu=False) as prof:
                for _ in range(reps):
                    cb._spec_dispatch(host)
            busy_ms, top = _kernel_table(prof, reps)
            t0 = time.perf_counter()
            for _ in range(reps):
                cb._spec_dispatch(host)
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            del saved, runs, caches
        row.update(replay_same_bits=same, walk_launches=walk,
                   iteration_host_wall_ms=wall_ms,
                   iteration_device_busy_ms=busy_ms,
                   iteration_idle_share=1 - busy_ms / wall_ms,
                   iteration_top_kernels=top[:6])
        out[name] = row
        del cb
    del untied
    out["f32_2_layers"] = _spec_f32(torch, vocab, max_len, page)
    return out


# the model-zoo phases (21-24, zoo, zoo-witness): tools/zoo_train.py's
# builders at their examples' widths, bf16 with Adam (bf16 moments)
# launches per training step of a zoo classifier: the softmax forward and
# backward, the loss's and the accuracy's means, one Adam update
ZOO_PER_STEP = {"softmax_fwd": 1, "softmax_bwd": 1, "reduce": 2,
                "optimizer_adam": 1}
# the fit steps of a graphed pair (phases 21, 22, 24): eager, and as
# ZOO_STEPS // ZOO_K dispatches of a CUDA graph of ZOO_K steps
ZOO_STEPS, ZOO_K = 12, 4
# three fit steps of each other builder, then three more timed
ZOO_OTHERS = ("alexnet", "mnist_mlp", "mnist_cnn", "cifar10_cnn",
              "resnext50", "inception_v3", "xdl", "candle_uno", "mlp_unify",
              "transformer", "moe", "moe_encoder")
# softmax launches a step where a builder has more than its classifier's:
# an MoE block's gate (2 layers of "moe"; 6 of MoeConfig()'s encoder)
ZOO_SOFTMAX_PER_STEP = {"moe": 3, "moe_encoder": 7}
# the MoE phases (25-27). Launches per step of the switch transformer
# (zoo_train.MOE_SWITCH: 2 MoE layers): the classifier's and the two
# gates' softmax, forward and backward, the gates' (1024, 256) and the
# classifier's (1024, 2) on "rows"; 2 + 2 flash launches on the tensor
# cores; 4 + 4 LayerNorm launches on "warp"; the loss's and the
# accuracy's means on "cta"; one Adam update
MOE_SWITCH_PER_STEP = dict(ZOO_PER_STEP, softmax_fwd=3, softmax_bwd=3,
                           flash_fwd=2, flash_bwd=2, layernorm_fwd=4,
                           layernorm_bwd=4)
MOE_SWITCH_ROUTES_PER_STEP = {"softmax_fwd/rows": 3, "softmax_bwd/rows": 3,
                              "flash_fwd/tc": 2, "flash_bwd/tc": 2,
                              "layernorm_fwd/warp": 4,
                              "layernorm_bwd/warp": 4, "reduce/cta": 2}
MFU_NOTE = ("MFU counts the FLOPs the port performs: the expert FFN and the "
            "dense ops; dispatch and combine are gathers, counted as zero "
            "(not ExpertsOp.flops()'s one-hot contractions, which the JAX "
            "package runs)")


def _host_tree(tree):
    return {op: {w: t.detach().cpu().clone() for w, t in ws.items()}
            for op, ws in tree.items()}


def _zoo_pair(torch, name, per_step=ZOO_PER_STEP):
    """tools/zoo_train.py's ZOO[name]: ZOO_STEPS eager fit steps, then a
    fresh model from the same weights and seed through
    fit(steps_per_execution=ZOO_K) over the same batches (the first
    dispatch eager then captured, the rest replayed); every dispatch's
    mean loss (the eager steps' over the same K), weight and running
    statistic the same bits, and each kernel of `per_step`
    launched its count a step eagerly and 2 x ZOO_K times for the graph.
    Then each model runs the steps again, timed, and the graphed one a
    dispatch more under the profiler (device busy, idle share, launches
    a step). Returns both runs' records and the eager model's trained
    weights on the host."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo

    xs, y = zoo.batches(name, ZOO_STEPS)
    runs, trees = {}, {}
    for label, k in (("eager", 1), ("graph", ZOO_K)):
        t0 = time.perf_counter()
        m = zoo.build(name, "cuda")
        build_s = time.perf_counter() - t0
        runs[label] = dict(zoo.train(m, xs, y, ZOO_STEPS, k),
                           build_s=build_s, params=zoo.n_params(m))
        trees[label] = (_host_tree(m.params), _host_tree(m.state))
        dropped = {op: float(vs["dropped"]) for op, vs in
                   trees[label][1].items() if "dropped" in vs}
        if dropped:  # an MoE model's router state after the fit
            runs[label]["router_dropped"] = dropped
        runs[label].update(zoo.time_steps(m, xs, y, ZOO_STEPS, k))
        if k > 1:
            n = ZOO_K * zoo.ZOO[name]["batch"]
            runs[label].update(zoo.profile_steps(
                m, [a[:n] for a in xs], y[:n], ZOO_K, k))
        del m
        torch.cuda.empty_cache()
    eager, graph = runs["eager"], runs["graph"]
    (we, se), (wg, sg) = trees["eager"], trees["graph"]
    # fit records a K-step dispatch's mean loss: the eager steps' f32 mean
    # over the same K, to the bit
    same = (_k_means(np, eager["losses"], ZOO_K) == graph["losses"]
            and all(torch.equal(t, wg[op][w]) for op, ws in we.items()
                    for w, t in ws.items())
            and all(torch.equal(t, sg[op][v]) for op, vs in se.items()
                    for v, t in vs.items()))
    if not same or not all(np.isfinite(eager["losses"])):
        raise AssertionError(f"{name}: the graphed steps differ from the "
                             f"eager ones, or a loss is not finite "
                             f"({eager['losses']} vs {graph['losses']})")
    wrong = {k: (eager["launches"].get(k, 0), graph["launches"].get(k, 0))
             for k, n in per_step.items()
             if eager["launches"].get(k, 0) != n * ZOO_STEPS
             or graph["launches"].get(k, 0) != 2 * ZOO_K * n}
    if wrong:
        raise AssertionError(f"{name}: launches (eager, graph) {wrong}, "
                             f"expected {per_step} a step")
    return runs, we


def _zoo_line(phase, name, runs):
    from flexflow_tpu_torch.tools import zoo_train as zoo

    eager, graph = runs["eager"], runs["graph"]
    return {"phase": phase, "model": name, "source": zoo.ZOO[name]["source"],
            "batch": zoo.ZOO[name]["batch"], "params": eager["params"],
            "card": _card_line(), "eager": eager, "graph": graph,
            "graph_same_bits": True,
            "ms_per_step": {"eager_k1": eager["ms_per_step"],
                            f"graph_k{ZOO_K}": graph["ms_per_step"]},
            "samples_per_s": {"eager_k1": eager["samples_per_s"],
                              f"graph_k{ZOO_K}": graph["samples_per_s"]},
            "mfu_bf16_peak": {"eager_k1": eager["mfu_bf16_peak"],
                              f"graph_k{ZOO_K}": graph["mfu_bf16_peak"]},
            "tolerance": "each graphed dispatch's mean loss (the eager "
                         "steps' f32 mean over it), weights and running "
                         "statistics equal to the eager run's bits"}


def phase_resnet(torch):
    """21: ResNet-50 at examples/python/native/resnet.py's widths (batch
    16, 3x224x224, 10 classes): the graphed pair."""
    runs, _ = _zoo_pair(torch, "resnet50")
    return _zoo_line("resnet", "resnet50", runs)


def phase_nmt(torch):
    """22: the LSTM NMT at build_lstm_nmt's defaults (vocab 32000 / 32000,
    embed 512, hidden 512, 2 layers; batch 32, seq 24): the graphed pair;
    the vocabulary softmax, forward and backward, at (768, 32000) and its
    routes."""
    runs, _ = _zoo_pair(torch, "nmt")
    line = _zoo_line("nmt", "nmt", runs)
    line["softmax_768x32000"] = {
        k: n for k, n in runs["eager"]["routes"].items()
        if k.startswith(("softmax_fwd/", "softmax_bwd/"))}
    return line


def phase_dlrm(torch, steps=5):
    """23: DLRM at DLRMConfig()'s defaults (four 1,000,000 x 64 f32
    tables, bot MLP 4-64-64, top 64-64-2, "cat" interaction; batch 64 as
    examples/python/native/dlrm.py), bag size 1 and bag size 8 (the SUM
    bags): `steps` eager fit steps each, finite losses, the launches a
    step; then `steps` more timed."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo

    out = {"phase": "dlrm", "card": _card_line(), "runs": {}}
    for name in ("dlrm", "dlrm_bag8"):
        t0 = time.perf_counter()
        m = zoo.build(name, "cuda")
        build_s = time.perf_counter() - t0
        xs, y = zoo.batches(name, steps)
        run = dict(zoo.train(m, xs, y, steps), build_s=build_s,
                   params=zoo.n_params(m), source=zoo.ZOO[name]["source"])
        run.update(zoo.time_steps(m, xs, y, steps))
        wrong = {k: run["launches"].get(k, 0) for k, n in
                 ZOO_PER_STEP.items()
                 if run["launches"].get(k, 0) != n * steps}
        if wrong or not all(np.isfinite(run["losses"])):
            raise AssertionError(f"{name}: launches {wrong}, losses "
                                 f"{run['losses']}")
        out["runs"][name] = run
        del m
        torch.cuda.empty_cache()
    return out


def phase_dropout(torch):
    """24: bench.py's flagship BERT with attention dropout 0.1: the
    graphed pair through the einsum core (no flash launch in training;
    K graphed steps the bits of K eager steps from the same generator
    state); then a fresh model at lr 0 on one repeated batch: two
    replays give other losses (new masks) and the weights stay (the
    initial weights: after one Adam step the flagship's classifier is
    saturated and its loss no longer shows a mask); inference on the
    trained weights through the flash kernel equals a dropout-0 model's
    to the bit."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools import zoo_train as zoo

    per_step = dict(ZOO_PER_STEP, layernorm_fwd=24, layernorm_bwd=24,
                    flash_fwd=0, flash_bwd=0)
    runs, trained = _zoo_pair(torch, "bert_dropout", per_step)
    line = _zoo_line("dropout", "bert_dropout", runs)
    m = zoo.build("bert_dropout", "cuda")
    init = _host_tree(m.params)
    xs, y = zoo.batches("bert_dropout", 1, seed=1)
    m.set_learning_rate(0.0)
    d = []
    for _ in range(3):
        # one dispatch a call: its steps' losses are the graph's static
        # output, which fit's record reduces to their mean
        m.fit([np.concatenate([xs[0]] * ZOO_K)], np.concatenate(
            [y] * ZOO_K), epochs=1, steps_per_execution=ZOO_K)
        d.append(_dispatch_losses(m, ZOO_K))
    still = all(torch.equal(t.cpu(), init[op][w])
                for op, ws in m.params.items() for w, t in ws.items())
    del init
    m.load_params(trained)
    if d[1] == d[2] or len(set(d[1] + d[2])) != 2 * ZOO_K or not still:
        raise AssertionError(f"dropout: at lr 0 two replays gave losses "
                             f"{d[1]} and {d[2]}; weights kept: {still}")
    plain = zoo.build("bert", "cuda")
    plain.load_params(trained)
    outs = []
    for model in (m, plain):
        reset_launch_counts()
        with torch.no_grad():
            feeds = model.executor.cast_inputs(
                {model.input_ops[0].name: torch.from_numpy(xs[0]).cuda()})
            outs.append(model.executor.forward_values(feeds)[
                model.final_tensor.guid])
        torch.cuda.synchronize()
        outs.append(launch_counts()["flash_fwd"])
    if not (torch.equal(outs[0], outs[2]) and outs[1] == outs[3] == 12):
        raise AssertionError(f"dropout: inference with dropout set differs "
                             f"from the dropout-0 model's, or not through "
                             f"12 flash launches ({outs[1]}, {outs[3]})")
    del m, plain
    torch.cuda.empty_cache()
    line.update(lr0_replay_losses=d[1:], inference_same_bits_as_dropout0=True,
                inference_flash_launches=outs[1])
    return line


def phase_zoo(torch, steps=3):
    """The other builders at their examples' widths (tools/zoo_train.py
    ZOO): `steps` eager fit steps each (finite losses, the classifiers'
    softmax and Adam launched), then `steps` more timed."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo

    out = {"phase": "zoo", "card": _card_line(), "models": {}}
    for name in ZOO_OTHERS:
        t0 = time.perf_counter()
        m = zoo.build(name, "cuda")
        build_s = time.perf_counter() - t0
        xs, y = zoo.batches(name, steps)
        run = dict(zoo.train(m, xs, y, steps), build_s=build_s,
                   params=zoo.n_params(m), source=zoo.ZOO[name]["source"])
        run.update(zoo.time_steps(m, xs, y, steps))
        run.pop("routes")
        need = {"optimizer_adam": 1} if zoo.ZOO[name].get("regression") \
            else {"optimizer_adam": 1, **dict.fromkeys(
                ("softmax_fwd", "softmax_bwd"),
                ZOO_SOFTMAX_PER_STEP.get(name, 1))}
        if not all(np.isfinite(run["losses"])) or any(
                run["launches"].get(k, 0) != n * steps
                for k, n in need.items()):
            raise AssertionError(f"zoo {name}: {run}")
        if name.startswith("moe"):
            run["mfu_note"] = MFU_NOTE
        out["models"][name] = run
        del m
        torch.cuda.empty_cache()
    return out


def phase_zoo_witness(torch, steps=2, tol=1e-3):
    """The f32 witnesses: build_resnet(stages=(1, 1)) at 64 px (batch 16)
    and the NMT cut to 1 layer (its default widths, batch 32, seq 24),
    `steps` Adam steps in f32 on the card and on the CPU from the card's
    weights, over the same batches: every loss within `tol` (relative)."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo

    out = {"phase": "zoo-witness", "card": _card_line(),
           "tolerance": f"|loss_card - loss_cpu| <= {tol} x |loss_cpu|"}
    for name in ("resnet_small", "nmt_1layer"):
        card = zoo.build(name, "cuda", mixed=False)
        cpu = zoo.build(name, "cpu", mixed=False)
        cpu.load_params(card.params)
        xs, y = zoo.batches(name, steps)
        losses = []
        for m in (card, cpu):
            m.fit(xs, y, epochs=1)
            losses.append([r["loss"] for r in m.step_stats.records()])
        err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        out[name] = {"card": losses[0], "cpu": losses[1],
                     "max_relative_err": err}
        if err > tol or not all(np.isfinite(losses[0])):
            raise AssertionError(f"zoo-witness {name}: {out[name]}")
        del card, cpu
        torch.cuda.empty_cache()
    return out


def phase_moe_switch(torch):
    """25: the switch transformer (zoo_train.MOE_SWITCH: hidden 1024, 16
    heads, 2 layers, 256 experts, top-2, capacity factor 2, lambda_bal
    0.01, vocab 8192; batch 8 x 128 tokens, 2 classes a token) in bf16
    with Adam: the graphed pair (12 eager steps, then 12 through K = 4
    from the same weights: losses, weights and router state the same
    bits), its launches and routes a step, assignments dropped (finite,
    the same in both runs); ms a step, samples/s, MFU (the port's FLOPs),
    peak memory, device busy, idle and launches a step."""
    import numpy as np

    runs, _ = _zoo_pair(torch, "moe_switch", MOE_SWITCH_PER_STEP)
    eager, graph = runs["eager"], runs["graph"]
    wrong = {k: eager["routes"].get(k, 0) for k, n in
             MOE_SWITCH_ROUTES_PER_STEP.items()
             if eager["routes"].get(k, 0) != n * ZOO_STEPS}
    if wrong:
        raise AssertionError(f"moe-switch: routes {wrong} in {ZOO_STEPS} "
                             f"steps, expected {MOE_SWITCH_ROUTES_PER_STEP} "
                             "a step")
    dropped = eager["router_dropped"]
    if (dropped != graph["router_dropped"]
            or not all(np.isfinite(v) for v in dropped.values())):
        raise AssertionError(f"moe-switch: router drops {dropped} vs "
                             f"{graph['router_dropped']}")
    line = _zoo_line("moe-switch", "moe_switch", runs)
    line.update(routes_per_step=MOE_SWITCH_ROUTES_PER_STEP,
                router_dropped_after_12_steps=dropped,
                assignments_per_step=8 * 128 * 2, capacity=16,
                mfu_note=MFU_NOTE,
                tolerance="graphed losses, weights and router state equal "
                          "to the eager run's bits")
    return line


def phase_moe_serve(torch, serve, prompts, news):
    """26: build_tiny_moe_lm at the serve phase's widths (hidden 1024, 16
    heads, 12 layers, vocab 30522, window 512; 4 experts, top-2, capacity
    factor 4 (no drops), lambda_bal 0), bf16, through
    ContinuousBatcher(num_slots=8, max_len=1024, page_size=16,
    prefix_cache_pages=0) as bench.run_moe drives it, on the serve phase's
    16 requests after 8 warm-up requests (one a slot): affinity on
    (window 4), then off. Each run's launches, counted from 0 just before
    it (the session references are made before), are those of the
    warm-up's walks, MOE_SERVE_PER_WALK each. Every request full length,
    the timed runs only replay graphs, affinity picks > 0, on and off the
    same tokens, the session's agreement reported (bf16, other GEMM
    shapes); then the router check walk (0 drops) and the ff_moe_* /
    ff_serving_affinity_* families in the exposition."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from flexflow_tpu_torch.obs.registry import REGISTRY
    from flexflow_tpu_torch.serving.sched.bench import (_moe_router_check,
                                                        build_tiny_moe_lm,
                                                        run_moe, session_refs)

    hidden, heads, layers, vocab, window = 1024, 16, 12, 30522, 512
    slots, max_len, page = 8, 1024, 16
    t0 = time.perf_counter()
    lm = build_tiny_moe_lm(slots, window, vocab=vocab, hidden=hidden,
                           heads=heads, layers=layers, experts=4,
                           moe_top_k=2, mixed_precision=True, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    work = [{"prompt": p, "max_new": int(n)} for p, n in zip(prompts, news)]
    refs = session_refs(lm, work, max_len)
    # the batcher's walks: the decode graph's warm-up and capture, and
    # those of each slot's chunk graph (one warm-up request a slot)
    walks = {"decode": 2, "chunk": 2 * slots}
    expected = {k: sum(n * MOE_SERVE_PER_WALK[w].get(k, 0)
                       for w, n in walks.items()) for k in SERVE_KERNELS}
    runs, launches, routes = {}, {}, {}
    for label, on in (("affinity_on", True), ("affinity_off", False)):
        reset_launch_counts()
        res = run_moe(lm, work, max_len, slots, page, deadline_s=600.0,
                      affinity_window=4, expert_affinity=on, refs=refs)
        counts = launch_counts()
        launches[label] = {k: counts[k] for k in SERVE_KERNELS}
        routes[label] = {k: n for k, n in counts.items() if "/" in k and n}
        warm = res["graphs_warmup"]
        if (warm["warmups"], warm["captures"], warm["eager_walks"]) != (
                1 + slots, 1 + slots, 0):
            raise AssertionError(f"moe-serve {label}: the warm-up must "
                                 f"capture the decode graph and {slots} "
                                 f"chunk graphs ({warm})")
        if launches[label] != expected:
            raise AssertionError(
                f"moe-serve {label}: launches {launches[label]} are not "
                f"{walks} walks of {MOE_SERVE_PER_WALK} ({expected})")
        graphs = res["stats"]["graphs"]
        timed = {k: v - warm[k] for k, v in graphs.items()}
        if (timed["replays"] == 0 or any(
                timed[k] for k in ("warmups", "captures", "eager_walks"))):
            raise AssertionError(f"moe-serve {label}: the timed run must "
                                 f"only replay graphs ({timed})")
        if res["dropped"]:
            raise AssertionError(f"moe-serve {label}: {res['dropped']} "
                                 "requests short or failed")
        ttft = np.array(res["ttft_s"]) * 1e3
        runs[label] = dict(
            tokens_per_s=res["tokens"] / res["wall_s"], wall_s=res["wall_s"],
            tokens=res["tokens"], ttft_ms_p50=float(np.percentile(ttft, 50)),
            ttft_ms_p99=float(np.percentile(ttft, 99)),
            decode_iter_ms=res["stats"]["decode_iter_s_mean"] * 1e3,
            decode_iterations=res["stats"]["decode_iterations"],
            prefill_chunks=res["stats"]["prefill_chunks"],
            session_identical_requests=len(work) - res["parity_mismatches"],
            graphs_timed=timed, affinity=res["affinity"],
            token_lists=res["token_lists"])
    on, off = runs["affinity_on"], runs["affinity_off"]
    if on["token_lists"] != off["token_lists"]:
        diff = sum(a != b for a, b in zip(on["token_lists"],
                                          off["token_lists"]))
        raise AssertionError(f"moe-serve: affinity on and off differ in "
                             f"{diff} of {len(work)} requests")
    if sum(on["affinity"]["picks"].values()) == 0:
        raise AssertionError(f"moe-serve: no affinity pick ({on['affinity']})")
    router = _moe_router_check(lm, work, window)
    if any(r["dropped"] for r in router.values()):
        raise AssertionError(f"moe-serve: the router dropped assignments "
                             f"{ {k: r['dropped'] for k, r in router.items()} }")
    text = REGISTRY.render()
    families = ("ff_moe_router_dropped_tokens_total", "ff_moe_expert_load",
                "ff_moe_expert_load_imbalance",
                "ff_serving_affinity_picks_total",
                "ff_serving_affinity_overlap")
    missing = [f for f in families if f not in text]
    if missing:
        raise AssertionError(f"moe-serve: families missing from the "
                             f"exposition: {missing}")
    for r in runs.values():
        r.pop("token_lists")
    n_params = sum(t.numel() for ws in lm.params.values()
                   for t in ws.values())
    del lm
    torch.cuda.empty_cache()
    return {"phase": "moe-serve", "params": n_params, "model_build_s": build_s,
            "card": _card_line(), "requests": len(work),
            "affinity_on_equals_off": True, **runs,
            "dense_serve": {k: serve[k] for k in (
                "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
                "decode_iter_ms")},
            "router_check": {k: {"dropped": r["dropped"], "load": r["load"]}
                             for k, r in router.items()},
            "families": list(families),
            "launches_per_walk": MOE_SERVE_PER_WALK, "walks_per_run": walks,
            "routes": routes,
            "launches": {k: sum(r[k] for r in launches.values())
                         for k in SERVE_KERNELS},
            "launches_cover": "each batcher's warm-up walks and captures "
                              "(the timed runs only replay); not the "
                              "session references or the router check"}


def phase_moe_witness(torch, steps=2, tol=1e-3):
    """27: the switch transformer cut to 1 layer, 16 experts, hidden 128
    (zoo_train "moe_switch_small"), `steps` Adam steps in f32 on the card
    and on the CPU from the card's weights over the same batches: every
    loss within `tol` (relative), the router's drops equal."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo

    name = "moe_switch_small"
    card = zoo.build(name, "cuda", mixed=False)
    cpu = zoo.build(name, "cpu", mixed=False)
    cpu.load_params(card.params)
    xs, y = zoo.batches(name, steps)
    losses, dropped = [], []
    for m in (card, cpu):
        m.fit(xs, y, epochs=1)
        losses.append([r["loss"] for r in m.step_stats.records()])
        dropped.append({op: float(vs["dropped"])
                        for op, vs in m.state.items()})
    err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    out = {"phase": "moe-witness", "card": _card_line(),
           "source": zoo.ZOO[name]["source"], "params": zoo.n_params(card),
           "losses_card": losses[0], "losses_cpu": losses[1],
           "max_relative_err": err, "dropped_card": dropped[0],
           "dropped_cpu": dropped[1],
           "tolerance": f"|loss_card - loss_cpu| <= {tol} x |loss_cpu|, "
                        "drops equal"}
    if err > tol or dropped[0] != dropped[1] or not all(
            np.isfinite(losses[0])):
        raise AssertionError(f"moe-witness: {out}")
    del card, cpu
    torch.cuda.empty_cache()
    return out


def _launch_check(phase, launches, want, batches=1):
    """Each kernel of `want` launched want[k] x batches times, and every
    other kernel (route keys aside) none."""
    wrong = {k: launches.get(k, 0) for k in set(launches) | set(want)
             if launches.get(k, 0) != want.get(k, 0) * batches
             and ("/" not in k or k in want)}
    if wrong:
        raise AssertionError(f"{phase}: launches {wrong}, expected "
                             f"{want} x {batches} and no other kernel")


def _predict_run(torch, model, x, batch, name):
    """predict twice (the same bits), launches of the first counted from 0
    just before it, then samples/s of a third call and host wall against
    device busy a batch under the profiler (padded: trace_device)."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.serve_profile import (_kernel_table,
                                                        trace_device)

    n = x.shape[0]
    batches = -(-n // batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = model.predict(x, batch_size=batch)
    launches = launch_counts()
    _launch_check(f"predict {name}", launches, PREDICT_PER_BATCH[name],
                  batches)
    if out.dtype != np.float32 or not np.isfinite(out).all() or \
            out.shape != (n,) + tuple(model.final_tensor.dims[1:]):
        raise AssertionError(f"predict {name}: output {out.dtype} "
                             f"{out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    if not np.array_equal(out, model.predict(x, batch_size=batch)):
        raise AssertionError(f"predict {name}: two calls differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.predict(x, batch_size=batch)
    wall = time.perf_counter() - t0
    with trace_device(cpu=False) as prof:
        t0 = time.perf_counter()
        model.predict(x, batch_size=batch)
        wall_prof = time.perf_counter() - t0
    busy_ms, top = _kernel_table(prof, batches)
    wall_ms = wall * 1e3 / batches
    return out, {
        "samples": n, "batch": batch, "batches": batches,
        "samples_per_s": n / wall, "wall_ms_per_batch": wall_ms,
        "wall_ms_per_batch_profiled": wall_prof * 1e3 / batches,
        "busy_ms_per_batch": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": top[:6],
        "launches": {k: v for k, v in launches.items() if v},
        "launches_per_batch": {k: launches[k] / batches
                               for k in PREDICT_PER_BATCH[name]}}


def _bn_stem(torch, x, batch):
    """ResNet-50's stem at its widths with a batch norm (conv 7x7/2 to 64
    channels, batch_norm, max pool, flat, dense 10, softmax; no zoo
    builder has a batch norm), bf16, Adam, after two fit steps from
    RandomState(28) labels, so its running statistics are not their
    initial values."""
    import numpy as np

    import flexflow_tpu_torch as pt

    m = pt.FFModel(pt.FFConfig(batch_size=batch, device="cuda"))
    t = m.conv2d(m.create_tensor([batch, 3, 224, 224]), 64, 7, 7, 2, 2, 3,
                 3)
    t = m.pool2d(m.batch_norm(t), 3, 3, 2, 2, 1, 1)
    m.softmax(m.dense(m.flat(t), 10))
    m.compile(optimizer=pt.AdamOptimizer(m, alpha=1e-4,
                                         moments_dtype=torch.bfloat16),
              generator=torch.Generator().manual_seed(0))
    y = np.random.RandomState(28).randint(0, 10, size=(x.shape[0], 1))
    m.fit(x, y, batch_size=batch, epochs=1)
    return m


def phase_predict(torch):
    """28: predict on the flagship and on ResNet-50 at full width (see the
    module docstring), with the f32 witness against the CPU."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train as zoo
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    t_phase = time.perf_counter()
    out = {"phase": "predict", "card": _card_line()}
    rng = np.random.RandomState(28)
    n, batch = PREDICT_RUNS["flagship"]
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    x = rng.randint(0, TRAIN["vocab"], size=(n, TRAIN["seq"])).astype(
        np.int32)
    _, out["flagship"] = _predict_run(torch, model, x, batch, "flagship")
    del model
    n, batch = PREDICT_RUNS["resnet50"]
    x = rng.randn(n, 3, 224, 224).astype(np.float32)
    for name in ("resnet50", "bn_stem"):
        model = zoo.build("resnet50", "cuda") if name == "resnet50" \
            else _bn_stem(torch, x[:2 * batch], batch)
        stats = _host_tree(model.state)
        _, out[name] = _predict_run(torch, model, x, batch, name)
        # predict reads the running statistics and writes none
        same = all(torch.equal(t, model.state[op][v].cpu())
                   for op, vs in stats.items() for v, t in vs.items())
        if not same:
            raise AssertionError(f"predict {name}: the running statistics "
                                 "changed")
        out[name]["state_same_bits"] = sum(len(vs) for vs in stats.values())
        del model
        torch.cuda.empty_cache()
    if not out["bn_stem"]["state_same_bits"]:
        raise AssertionError("predict bn_stem: no running statistics")
    # the witness: 2 layers, f32, the card against the CPU
    card = build_bench_model("cuda", 2, False, 0)
    cpu = build_bench_model("cpu", 2, False, 1)
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in card.params.items()})
    x = rng.randint(0, TRAIN["vocab"], size=(11, TRAIN["seq"])).astype(
        np.int32)
    p_card = card.predict(x, batch_size=8)
    p_cpu = cpu.predict(x, batch_size=8)
    err = float(np.abs(p_card - p_cpu).max())
    out["witness"] = {"layers": 2, "samples": 11, "max_abs_err": err,
                      "tolerance": 1e-3}
    if not err <= 1e-3:
        raise AssertionError(f"predict witness: card vs CPU {err}")
    del card, cpu
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def phase_manual(torch):
    """29: the manual loop against fit on the flagship, and one truncated
    iteration (see the module docstring)."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    t_phase = time.perf_counter()
    b = TRAIN["batch"]
    x, y = _train_batch()
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    model.fit(np.concatenate([x, x]), np.concatenate([y, y]), batch_size=b,
              epochs=1)
    fit_losses = [r["loss"] for r in model.step_stats.records()]
    fit_w = _host_tree(model.params)
    del model
    torch.cuda.empty_cache()
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    model.set_iteration_batch([x], y)
    losses = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(2):
        pred = model.forward()
        losses.append(float(model.loss.fn(pred, model._manual["label"])))
        model.zero_gradients()
        model.backward()
        model.update()
    torch.cuda.synchronize()
    launches = launch_counts()
    # a manual iteration: a forward walk and its loss, the backward's walk,
    # loss and backward, one update
    want = dict(TRAIN_PER_STEP, flash_fwd=24, layernorm_fwd=48,
                softmax_fwd=2)
    _launch_check("manual", {k: v for k, v in launches.items()
                             if "/" not in k}, want, 2)
    same_w = all(torch.equal(t.cpu(), fit_w[op][w])
                 for op, ws in model.params.items() for w, t in ws.items())
    if losses != fit_losses or not same_w:
        raise AssertionError(f"manual: losses {losses} against fit's "
                             f"{fit_losses}, weights equal {same_w}")
    del fit_w
    torch.cuda.synchronize()
    reset_launch_counts()
    model.forward(seq_length=MANUAL_SEQ)
    fwd = launch_counts()
    reset_launch_counts()
    model.backward(seq_length=MANUAL_SEQ)
    torch.cuda.synchronize()
    bwd = launch_counts()
    finite = all(bool(torch.isfinite(g).all())
                 for ws in model._manual["grads"].values()
                 for g in ws.values())
    wrong = {k: (fwd.get(k, 0), bwd.get(k, 0))
             for k in set(MANUAL_FORWARD) | set(MANUAL_BACKWARD)
             if fwd.get(k, 0) != MANUAL_FORWARD.get(k, 0)
             or bwd.get(k, 0) != MANUAL_BACKWARD.get(k, 0)}
    if wrong or not finite:
        raise AssertionError(f"manual seq_length={MANUAL_SEQ}: flash "
                             f"launches (forward, backward) {wrong}, "
                             f"finite gradients {finite}")
    del model
    torch.cuda.empty_cache()
    return {"phase": "manual", "card": _card_line(), "iterations": 2,
            "losses": losses, "fit_losses": fit_losses,
            "weights_same_bits": True,
            "tolerance": "losses and final weights equal to fit's bits",
            "launches": {k: v for k, v in launches.items() if v},
            "seq_length": MANUAL_SEQ,
            "truncated_forward_launches": {k: fwd.get(k, 0)
                                           for k in MANUAL_FORWARD},
            "truncated_backward_launches": {k: bwd.get(k, 0)
                                            for k in MANUAL_BACKWARD},
            "wall_s": time.perf_counter() - t_phase}


def phase_checkpoint(torch, lm):
    """30: durable checkpoints into a captured K = 4 graph, and the
    tracer's spans (see the module docstring)."""
    import shutil
    import tempfile

    import numpy as np

    from flexflow_tpu_torch.obs.tracing import (disable_tracing,
                                                enable_tracing)
    from flexflow_tpu_torch.runtime.durability import (
        DurableCheckpointer, checkpoint_counters, reset_checkpoint_counters)
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    t_phase = time.perf_counter()
    b, k = TRAIN["batch"], GRAPH_K
    x, y = _train_batch()
    xs, ys = np.concatenate([x] * k), np.concatenate([y] * k)
    tmp = tempfile.mkdtemp(prefix="ff_ckpt_")
    tracer = enable_tracing()
    tracer.clear()
    reset_checkpoint_counters()
    try:
        model = build_bench_model("cuda", 2, True, 0)
        n_params = sum(t.numel() for ws in model.params.values()
                       for t in ws.values())
        model.fit(xs, ys, batch_size=b, epochs=1, steps_per_execution=k)
        ckpt = DurableCheckpointer(tmp, keep_last=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(model, step=model._step_count)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        saved_pred = model.predict(x, batch_size=b)
        model.fit(xs, ys, batch_size=b, epochs=1, steps_per_execution=k)
        a = _dispatch_losses(model, k)
        counts = dict(model._multi_step(k).counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, _ = ckpt.restore_latest(model)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        model.fit(xs, ys, batch_size=b, epochs=1, steps_per_execution=k)
        bb = _dispatch_losses(model, k)
        graphs = dict(model._multi_step(k).counts)
        if a != bb or not np.isfinite(a).all():
            raise AssertionError(f"checkpoint: losses after the restore "
                                 f"{bb} differ from those after the save "
                                 f"{a}")
        if graphs["captures"] != counts["captures"] or \
                graphs["replays"] != counts["replays"] + 1:
            raise AssertionError(f"checkpoint: graph counts {counts} -> "
                                 f"{graphs}, expected one more replay "
                                 "and no capture")
        del model
        fresh = build_bench_model("cuda", 2, True, 1)
        ckpt.restore_latest(fresh)
        if not np.array_equal(fresh.predict(x, batch_size=b), saved_pred):
            raise AssertionError("checkpoint: the restored fresh model "
                                 "predicts other bits than the saved one")
        del fresh
        torch.cuda.empty_cache()
        counters = checkpoint_counters()
        spans = {name: len(tracer.events(name)) for name in (
            "checkpoint.save", "checkpoint.restore", "executor.multi_step",
            "executor.train_step")}
        if spans != {"checkpoint.save": 1, "checkpoint.restore": 2,
                     "executor.multi_step": 3,
                     "executor.train_step": 0} or any(
                counters.get(c, 0) < 1
                for c in ("saved", "verified", "restored")):
            raise AssertionError(f"checkpoint: spans {spans}, counters "
                                 f"{counters}")
        # the batcher's spans, on the scheduler thread's named track
        tracer.clear()
        rng = np.random.RandomState(30)
        with ContinuousBatcher(lm, max_len=1024, num_slots=8, page_size=16,
                               trace_label="smoke") as cb:
            reqs = [cb.submit(rng.randint(0, 30522, size=40), 4)
                    for _ in range(2)]
            for r in reqs:
                r.result(timeout=600)
        trace_path = tracer.export_chrome_trace(os.path.join(tmp,
                                                             "serve.json"))
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        smoke = {e["tid"] for e in events if e.get("ph") == "M"
                 and e.get("name") == "thread_name"
                 and e["args"]["name"] == "smoke"}
        on_smoke = {}
        for e in events:
            if e.get("ph") == "X" and e["tid"] in smoke:
                on_smoke[e["name"]] = on_smoke.get(e["name"], 0) + 1
        if not smoke or not on_smoke.get("serve.prefill") or \
                not on_smoke.get("serve.decode"):
            raise AssertionError(f"checkpoint: serve spans on the 'smoke' "
                                 f"thread {on_smoke}")
    finally:
        disable_tracing()
        tracer.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "checkpoint", "card": _card_line(),
            "params": n_params, "file_bytes": size, "save_s": save_s,
            "restore_s": restore_s, "restored_step": step,
            "losses_after_save": a, "losses_after_restore": bb,
            "graph_counts": graphs, "counters": counters, "spans": spans,
            "serve_spans_on_smoke": on_smoke,
            "tolerance": "losses after the restore equal those after the "
                         "save to the bit; the restored fresh model's "
                         "predict the saved model's bits",
            "wall_s": time.perf_counter() - t_phase}


# phase 31: the server's batch buckets, its client threads and requests
# each (1-3 rows a request), the /generate prompts' lengths and new tokens
SERVER_BUCKETS = (1, 4, 8)
SERVER_CLIENTS, SERVER_REQUESTS = 6, 16
SERVER_GEN = ((48, 96, 130), 16)
# a response against InferenceModel.predict of its own rows: another
# bucket may take other GEMM algorithms, so bf16 rounding differs
SERVER_TOL = 5e-2
# phase 32: the folded stem against the unfolded one (bf16: the folded
# conv rounds k * s and its bias to bf16 where the batch norm computed in
# f32 after the bf16 conv)
FOLD_TOL = 5e-2
BUCKET_ITERS = 20


def _http(port, path, payload=None):
    """(status, headers, body) of one GET (payload None) or JSON POST to
    the local server."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, dict(r.headers), r.read()


def _call_times(torch, fn, n=BUCKET_ITERS):
    """Host wall of fn() (which ends in a device sync) over n calls, and
    device busy a call under the profiler (padded: trace_device) over n
    more: {"wall_ms", "wall_ms_profiled", "busy_ms", "device_idle_share",
    "top_kernels"}."""
    from flexflow_tpu_torch.tools.serve_profile import (_kernel_table,
                                                        trace_device)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with trace_device(cpu=False) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_prof = (time.perf_counter() - t0) * 1e3 / n
    busy, top = _kernel_table(prof, n)
    return {"wall_ms": wall, "wall_ms_profiled": wall_prof, "busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall, "top_kernels": top[:5]}


def _bucket_vs_eager(torch, model, im, x):
    """One full bucket through the InferenceModel's graph and the same
    rows through the eager predict walk: the same bits, and each one's
    host wall, device busy and idle a call, samples/s."""
    import numpy as np

    feed = {model.input_ops[0].name: x}
    n = x.shape[0]
    graph = im.predict(feed)
    eager = model.predict(x, batch_size=n)
    if not np.array_equal(graph, eager) or not np.isfinite(graph).all():
        raise AssertionError(f"bucket {n}: a replay differs from the eager "
                             f"walk by {float(np.abs(graph - eager).max())}")
    out = {"rows": n, "replay_equals_eager_walk": True}
    for name, fn in (("bucket", lambda: im.predict(feed)),
                     ("eager_predict",
                      lambda: model.predict(x, batch_size=n))):
        out[name] = _call_times(torch, fn)
        out[name]["samples_per_s"] = n * 1e3 / out[name]["wall_ms"]
    return graph, out


def _analysis_warning(torch):
    """A compile whose imported strategy file names an op the graph lacks:
    the plan analysis records one FFTA051 warning (process-wide, so the
    server's /metrics and stats() carry it)."""
    import tempfile

    from flexflow_tpu_torch import FFConfig, FFModel

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "strategy.json")
        with open(path, "w") as f:
            json.dump({"mesh_axes": {}, "ops": {"not_in_this_graph":
                                                {"dp": 1, "tp": 1}}}, f)
        m = FFModel(FFConfig(batch_size=8, device="cuda",
                             import_strategy_file=path))
        m.dense(m.create_tensor([8, 16]), 4)
        m.compile()
    del m
    torch.cuda.empty_cache()


def phase_server(torch, lm, predict):
    """31: the HTTP server at full width (see the module docstring)."""
    import threading

    import numpy as np

    from flexflow_tpu_torch.elastic import TrainingWatchdog, WatchdogPolicy
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.serving import InferenceModel, InferenceServer
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    t_phase = time.perf_counter()
    rng = np.random.RandomState(31)
    vocab, seq = TRAIN["vocab"], TRAIN["seq"]
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    name = model.input_ops[0].name
    server = InferenceServer()
    server.register("bert", model, max_batch_size=max(SERVER_BUCKETS),
                    max_delay_ms=2.0, batch_buckets=SERVER_BUCKETS)
    im = server._models["bert"].model
    cb = ContinuousBatcher(lm, max_len=1024, num_slots=8, page_size=16)
    server.register_continuous("lm", cb)
    httpd = server.serve_http(port=0)
    port = httpd.server_address[1]
    try:
        # every graph of the continuous batcher captured (one request a
        # slot), then the tokens /generate must give, by direct submit
        warm = [cb.submit(rng.randint(0, vocab, size=40), 4)
                for _ in range(8)]
        for r in warm:
            r.result(timeout=600)
        gen_prompts = [rng.randint(0, vocab, size=n).astype(np.int32)
                       for n in SERVER_GEN[0]]
        direct = [cb.submit(p, SERVER_GEN[1]).result(timeout=600).tolist()
                  for p in gen_prompts]
        cb_graphs = dict(cb.stats()["graphs"])
        # each bucket's first call, an eager warm-up and its capture,
        # through the server's DynamicBatcher thread, while another thread
        # keeps the continuous batcher replaying its graphs (which launch
        # no counted kernel)
        errors, overlap, stop = [], [], threading.Event()

        def replaying():
            try:
                while not stop.is_set():
                    overlap.append([cb.submit(p, SERVER_GEN[1]).result(
                        timeout=600).tolist() for p in gen_prompts])
            except Exception as e:  # surfaced below
                errors.append(e)

        torch.cuda.synchronize()
        reset_launch_counts()
        bg = threading.Thread(target=replaying)
        bg.start()
        capture_s = {}
        try:
            for rows, bucket in zip((1, 3, 8), SERVER_BUCKETS):
                t0 = time.perf_counter()
                server.infer("bert", {name: rng.randint(
                    0, vocab, size=(rows, seq)).astype(np.int32)},
                    timeout=600)
                capture_s[bucket] = time.perf_counter() - t0
        finally:
            stop.set()
            bg.join(timeout=600)
        if errors or not overlap or any(o != direct for o in overlap):
            raise AssertionError(f"server: the batcher's tokens while the "
                                 f"buckets captured: {errors[:3]}, "
                                 f"{len(overlap)} rounds")
        warm_launches = launch_counts()
        _launch_check("server buckets", warm_launches,
                      PREDICT_PER_BATCH["flagship"], 2 * len(SERVER_BUCKETS))
        warm_counts = dict(im.counts)

        reqs = [[rng.randint(0, vocab, size=(int(rng.randint(1, 4)), seq))
                 .astype(np.int32) for _ in range(SERVER_REQUESTS)]
                for _ in range(SERVER_CLIENTS)]
        outs = [[None] * SERVER_REQUESTS for _ in range(SERVER_CLIENTS)]
        gen = {}

        def client(i):
            try:
                for j, x in enumerate(reqs[i]):
                    body = _http(port, "/v2/models/bert/infer",
                                 {"inputs": {name: x.tolist()}})[2]
                    outs[i][j] = np.asarray(json.loads(body)["outputs"],
                                            np.float32)
            except Exception as e:  # surfaced below
                errors.append(e)

        def gen_client():
            try:
                path = "/v2/models/lm/generate"
                gen["plain"] = json.loads(_http(port, path, {
                    "prompt": [p.tolist() for p in gen_prompts],
                    "max_new_tokens": SERVER_GEN[1]})[2])["tokens"]
                gen["stream"], gen["trailer"] = [], []
                for p in gen_prompts:
                    _, headers, body = _http(port, path, {
                        "prompt": p.tolist(),
                        "max_new_tokens": SERVER_GEN[1], "stream": True})
                    lines = [json.loads(ln) for ln in body.splitlines()]
                    gen["stream"].append([ln["token"] for ln in lines[:-1]])
                    gen["trailer"].append(lines[-1])
                gen["content_type"] = headers["Content-Type"]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVER_CLIENTS)]
        threads.append(threading.Thread(target=gen_client))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        traffic_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server: client errors {errors[:3]}")
        traffic_launches = {k: v - warm_launches.get(k, 0)
                            for k, v in launch_counts().items()
                            if v != warm_launches.get(k, 0)}
        counts = dict(im.counts)
        calls = counts["replays"] - warm_counts["replays"]
        if (counts["captures"] != len(SERVER_BUCKETS)
                or counts["warmups"] != len(SERVER_BUCKETS)
                or counts["eager_walks"] or traffic_launches
                or sorted(im._fns) != list(SERVER_BUCKETS)):
            raise AssertionError(
                f"server: buckets {sorted(im._fns)}, graph counts {counts}, "
                f"launches during the traffic {traffic_launches}: the "
                "traffic must only replay")
        cb_after = dict(cb.stats()["graphs"])
        if any(cb_after[k] != cb_graphs[k]
               for k in ("warmups", "captures", "eager_walks")):
            raise AssertionError(f"server: the continuous batcher's graphs "
                                 f"{cb_graphs} -> {cb_after}")
        if gen["plain"] != direct or gen["stream"] != direct or any(
                t["tokens"] != d or t["done"] is not True
                for t, d in zip(gen["trailer"], direct)):
            raise AssertionError(f"server: /generate tokens {gen} differ "
                                 f"from the direct submit's {direct}")
        rows = sum(x.shape[0] for r in reqs for x in r)
        err = 0.0
        for r, o in zip(reqs, outs):
            for x, got in zip(r, o):
                want = im.predict({name: x})
                if got.shape != want.shape:
                    raise AssertionError(f"server: response {got.shape}, "
                                         f"expected {want.shape}")
                err = max(err, float(np.abs(got - want).max()))
        if not err <= SERVER_TOL:
            raise AssertionError(f"server: responses {err} from predict")

        # one full bucket of 8: the graph against the eager walk
        x8 = rng.randint(0, vocab, size=(8, seq)).astype(np.int32)
        _, bucket8 = _bucket_vs_eager(torch, model, im, x8)

        # /metrics after one forced watchdog check (the ff_checkpoint_*
        # counters are phase 30's), /healthz
        TrainingWatchdog(WatchdogPolicy(warmup_steps=0)).check(
            0, float("nan"))
        _analysis_warning(torch)
        text = _http(port, "/metrics")[2].decode()
        fams = validate_exposition(text)
        prefixes = ("ff_inference_", "ff_serving_", "ff_kvpool_",
                    "ff_checkpoint_", "ff_watchdog_",
                    "ff_plan_diagnostics_total")
        missing = [p for p in prefixes
                   if not any(f.startswith(p) for f in fams)]
        status, _, body = _http(port, "/healthz")
        health = json.loads(body)
        if missing or status != 200 or health["status"] != "ok" or \
                health["models"] != ["bert"] or \
                health["continuous"] != ["lm"]:
            raise AssertionError(f"server: /metrics lacks {missing} or "
                                 f"/healthz {status} {health}")
        stats = server.stats()
        if not stats.get("_analysis", {}).get("FFTA051"):
            raise AssertionError(f"server: stats()['_analysis'] lacks the "
                                 f"compile's FFTA051: {stats.get('_analysis')}")
    finally:
        httpd.shutdown()
        server.shutdown()
    del model, im, cb
    torch.cuda.empty_cache()

    # the f32 witness: a 2-layer f32 flagship's buckets against the CPU
    card = build_bench_model("cuda", 2, False, 0)
    cpu = build_bench_model("cpu", 2, False, 1)
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in card.params.items()})
    x = rng.randint(0, vocab, size=(5, seq)).astype(np.int32)
    got = InferenceModel(card, (4,)).predict({name: x})
    want = InferenceModel(cpu, (4,)).predict({name: x})
    werr = float(np.abs(got - want).max())
    if not werr <= 1e-4:
        raise AssertionError(f"server witness: card vs CPU {werr}")
    del card, cpu
    torch.cuda.empty_cache()
    return {
        "phase": "server", "card": _card_line(), "buckets": SERVER_BUCKETS,
        "capture_s": capture_s, "graph_counts": counts,
        "batcher_rounds_during_captures": len(overlap),
        "bucket_calls_in_traffic": calls,
        "launches": {k: v for k, v in warm_launches.items() if v},
        "launches_cover": "each bucket's eager warm-up and its capture "
                          "(2 walks a bucket); the traffic only replays "
                          "and launched nothing",
        "clients": SERVER_CLIENTS, "requests": SERVER_CLIENTS
        * SERVER_REQUESTS, "rows": rows, "traffic_s": traffic_s,
        "http_samples_per_s": rows / traffic_s,
        "max_abs_err_vs_predict": err, "tolerance": SERVER_TOL,
        "bucket8": bucket8,
        "eager_predict_phase28": {
            k: predict["flagship"][k] for k in (
                "samples_per_s", "wall_ms_per_batch", "busy_ms_per_batch",
                "device_idle_share")},
        "generate": {"prompts": list(SERVER_GEN[0]),
                     "new_tokens": SERVER_GEN[1],
                     "plain_and_stream_equal_direct": True,
                     "content_type": gen["content_type"],
                     "continuous_graphs": cb_after},
        "metrics_families": len(fams),
        "metrics_prefixes": {p: sorted(f for f in fams if f.startswith(p))
                             for p in prefixes},
        "stats_keys": sorted(stats),
        "analysis_counts": stats["_analysis"],
        "witness": {"layers": 2, "rows": 5, "buckets": [4],
                    "max_abs_err": werr, "tolerance": 1e-4},
        "wall_s": time.perf_counter() - t_phase}


def phase_fold(torch, predict):
    """32: fold_batchnorm under an InferenceModel, and ResNet-50 through
    its bucket (see the module docstring)."""
    import numpy as np

    from flexflow_tpu_torch import OpType
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.serving import InferenceModel, fold_batchnorm
    from flexflow_tpu_torch.tools import zoo_train as zoo

    t_phase = time.perf_counter()
    out = {"phase": "fold", "card": _card_line()}
    batch = PREDICT_RUNS["resnet50"][1]
    rng = np.random.RandomState(32)
    x = rng.randn(2 * batch, 3, 224, 224).astype(np.float32)
    stem = _bn_stem(torch, x, batch)
    name = stem.input_ops[0].name
    im = InferenceModel(stem, (batch,))
    feed = {name: x[:batch]}
    bns = [op.name for op in stem.ops if op.op_type == OpType.BATCHNORM]
    runs = {}
    for stage in ("before", "after"):
        if stage == "after":
            folded = fold_batchnorm(stem)
            if folded != bns or len(bns) != 1:
                raise AssertionError(f"fold: folded {folded}, batch norms "
                                     f"{bns}")
        torch.cuda.synchronize()
        reset_launch_counts()
        pred = im.predict(feed)
        launches = launch_counts()
        _launch_check(f"fold {stage}", launches,
                      PREDICT_PER_BATCH["bn_stem"], 2)
        if not np.isfinite(pred).all():
            raise AssertionError(f"fold {stage}: non-finite output")
        kernels = _device_kernels(torch, lambda: im.predict(feed), 3)
        runs[stage] = {"pred": pred, "launches": {
            k: v for k, v in launches.items() if v},
            "device_kernels_per_replay": sum(kernels.values()),
            "kernels": kernels,
            "times": _call_times(torch, lambda: im.predict(feed))}
    before, after = runs["before"], runs["after"]
    err = float(np.abs(after["pred"] - before["pred"]).max())
    gone = sorted(set(before["kernels"]) - set(after["kernels"]))
    if not err <= FOLD_TOL or im.counts["captures"] != 2 or \
            after["device_kernels_per_replay"] >= \
            before["device_kernels_per_replay"]:
        raise AssertionError(
            f"fold: max err {err}, graph counts {im.counts}, device kernels "
            f"a replay {before['device_kernels_per_replay']} -> "
            f"{after['device_kernels_per_replay']}")
    try:
        stem.fit(x, np.zeros((2 * batch, 1), np.int32), batch_size=batch,
                 epochs=1)
        raise AssertionError("fold: fit ran on a folded model")
    except RuntimeError as e:
        if "optimized for inference" not in str(e):
            raise
    out["bn_stem"] = {
        "folded": folded, "max_abs_err": err, "tolerance": FOLD_TOL,
        "graph_counts": dict(im.counts),
        "fit_refused": True, "kernels_gone": gone,
        **{stage: {k: v for k, v in r.items() if k not in ("pred",
                                                           "kernels")}
           for stage, r in runs.items()}}
    del stem, im
    torch.cuda.empty_cache()

    resnet = zoo.build("resnet50", "cuda")
    im = InferenceModel(resnet, (batch,))
    torch.cuda.synchronize()
    reset_launch_counts()
    im.predict({resnet.input_ops[0].name: x[:batch]})
    launches = launch_counts()
    _launch_check("fold resnet50", launches, PREDICT_PER_BATCH["resnet50"],
                  2)
    _, out["resnet50"] = _bucket_vs_eager(torch, resnet, im, x[:batch])
    out["resnet50"]["launches"] = {k: v for k, v in launches.items() if v}
    out["resnet50"]["input_bytes"] = int(x[:batch].nbytes)
    out["resnet50"]["eager_predict_phase28"] = {
        k: predict["resnet50"][k] for k in (
            "samples_per_s", "wall_ms_per_batch", "busy_ms_per_batch",
            "device_idle_share")}
    del resnet, im
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def _first_token_probs(torch, cb, prompts, page):
    """Each prompt's first-token distribution from batcher `cb`'s captured
    chunk graph: the prompt replayed chunk by chunk through slot 0, the
    last row of the last chunk read (on the host)."""
    import numpy as np

    out = []
    with torch.no_grad():
        for prompt in prompts:
            for off in range(0, len(prompt), page):
                n = min(page, len(prompt) - off)
                host = np.zeros(page + 1, np.int32)
                host[:n] = prompt[off:off + n]
                host[page] = off
                cb._chunk_dispatch(0, host)
            # a copy: the static buffer is the next chunk's output
            out.append(cb._chunk_probs[0, n - 1].float().cpu().clone())
    return out


def _model_bits(torch, model):
    """Every weight and state buffer of `model` (cloned on its device) and
    its training generator's state."""
    return ([(op.name, n, v.detach().clone()) for op in model.ops
             for n, v in list(op.named_parameters())
             + list(op.named_buffers())],
            model.executor.generator.get_state().clone())


def _same_bits(torch, model, bits):
    tensors, gen = bits
    now = {(op.name, n): v for op in model.ops
           for n, v in list(op.named_parameters())
           + list(op.named_buffers())}
    changed = [f"{o}/{n}" for o, n, v in tensors
               if not torch.equal(now[(o, n)], v)]
    if not torch.equal(gen, model.executor.generator.get_state()):
        changed.append("generator")
    return changed


def _crossover_sweep(torch, rounds=CROSSOVER_ROUNDS):
    """OpCostCache's measurement of one attention op (h 16, d 64, bf16
    mixed precision) with use_flash True and False at b in (1, 8), l in
    CROSSOVER_LENGTHS: forward and forward + backward us, each the median
    of `rounds` rounds (a fresh cache a round, the two impls in turns),
    beside the score bytes the registry's crossover compares (4 b h l^2).
    At these shapes the eager op is bound by the host's launches, so the
    rounds' spread is printed too. The sweep's crossover: the largest
    score bytes below which the einsum core's median forward + backward
    beats flash's at every swept shape (0 when flash is at or under it at
    the smallest)."""
    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.kernels.registry import \
        FLASH_SCORE_BYTES_CROSSOVER
    from flexflow_tpu_torch.search.simulator import OpCostCache, OpStrategy

    ops = {}
    for b in (1, 8):
        for seq in CROSSOVER_LENGTHS:
            for flash in (True, False):
                m = FFModel(FFConfig(batch_size=b, device="cuda"))
                t = m.create_tensor([b, seq, 1024])
                m.multihead_attention(t, t, t, 1024, 16, use_flash=flash)
                ops[(b, seq, flash)] = m.ops[-1]
    times = {k: [] for k in ops}
    misses = 0
    for rnd in range(rounds):
        cache = OpCostCache(FFConfig(device="cuda"), warmup=3, repeats=20)
        for (b, seq, flash), op in sorted(
                ops.items(), key=lambda kv: (kv[0][:2], kv[0][2] != rnd % 2)):
            fwd, bwd = cache.measure_us(op, OpStrategy())
            if fwd <= 0 or bwd < 0:
                raise AssertionError(f"crossover sweep: {b}x{seq} "
                                     f"flash={flash} unmeasured: "
                                     f"{cache.failures}")
            times[(b, seq, flash)].append((fwd, fwd + bwd))
        misses += cache.misses
    rows = []
    for b in (1, 8):
        for seq in CROSSOVER_LENGTHS:
            row = {"b": b, "l": seq, "score_bytes": 4.0 * b * 16 * seq * seq}
            for flash, tag in ((True, "flash"), (False, "einsum")):
                t = np.array(times[(b, seq, flash)])
                row[f"{tag}_fwd_us"] = float(np.median(t[:, 0]))
                row[f"{tag}_fwd_bwd_us"] = float(np.median(t[:, 1]))
                row[f"{tag}_fwd_bwd_us_min_max"] = [float(t[:, 1].min()),
                                                    float(t[:, 1].max())]
            row["flash_wins_fwd"] = row["flash_fwd_us"] <= row["einsum_fwd_us"]
            row["flash_wins_fwd_bwd"] = (row["flash_fwd_bwd_us"]
                                         <= row["einsum_fwd_bwd_us"])
            rows.append(row)
    crossover = 0.0
    for r in sorted(rows, key=lambda r: r["score_bytes"]):
        if r["flash_wins_fwd_bwd"]:
            break
        crossover = r["score_bytes"]
    return {"rows": rows, "rounds": rounds, "measurements": misses,
            "crossover_bytes_in_use": FLASH_SCORE_BYTES_CROSSOVER,
            "crossover_bytes_from_sweep": crossover,
            "flash_wins_every_shape_fwd_bwd": all(
                r["flash_wins_fwd_bwd"] for r in rows)}


def phase_cost(torch, train, steps=10, warmup=3):
    """Phase 33: the cost model and its calibration loop on the flagship.
    fit with profiling at K = 1 (warmup + steps) and K = 4, StepStats'
    MFU against the train phase's formula on the same steps; the
    simulator with OpCostCache's measurements; profile_ops; calibrate;
    refit against the K = 1 StepStats p50 (3 rounds, tol 0.15); the
    FittedProfile saved for h100-sxm / gpu and reloaded through
    make_machine_model; the registry's residual evidence from it; a
    DriftDetector over `steps` more steps; the task-graph dot written
    and parsed back; and the flash crossover sweep."""
    import dataclasses
    import re
    import tempfile

    import numpy as np

    from flexflow_tpu_torch.kernels.registry import KERNELS, OPTYPE_FAMILY
    from flexflow_tpu_torch.obs import (REGISTRY, DriftDetector, calibrate,
                                        refit)
    from flexflow_tpu_torch.runtime.profiling import profile_ops
    from flexflow_tpu_torch.search.machine_model import make_machine_model
    from flexflow_tpu_torch.search.simulator import OpCostCache, Simulator
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    model.config.profiling = True
    b = TRAIN["batch"]
    x, y = _train_batch()
    model.fit(x, y, batch_size=b, epochs=warmup)
    model.fit(x, y, batch_size=b, epochs=steps)
    k1 = model.step_stats
    k1_records = k1.records()
    stats_mfu = float(np.median([r["mfu"] for r in k1_records]))
    formula_mfu = float(np.median(
        [train_step_flops(**TRAIN) / (r["step_ms"] / 1e3)
         / PEAK_OPS_PER_S["bfloat16"] for r in k1_records]))
    # one clock (the records' own step_ms): this holds
    # StepStats' FLOPs a step (from the graph) and peak (from the spec)
    # against the train phase's formula and the data sheet's peak
    if abs(stats_mfu / formula_mfu - 1.0) > 0.05:
        raise AssertionError(f"StepStats MFU {stats_mfu} vs the train "
                             f"phase's formula {formula_mfu} on the same "
                             f"steps: more than 5% apart")
    # K = 4: one dispatch warms and captures, three are read
    xk, yk = np.concatenate([x] * GRAPH_K), np.concatenate([y] * GRAPH_K)
    model.fit(xk, yk, batch_size=b, epochs=1, steps_per_execution=GRAPH_K)
    model.fit(xk, yk, batch_size=b, epochs=3, steps_per_execution=GRAPH_K)
    k4 = model.step_stats.summary()
    model.step_stats = k1

    bits = _model_bits(torch, model)
    measured = OpCostCache(model.config, warmup=2, repeats=10)
    machine = make_machine_model(model.config, 1)
    sim_measured_us = Simulator(machine, model.config,
                                measured=measured).simulate(model.graph, {})
    failures = dict(measured.failures)
    rows = profile_ops(model)
    report = calibrate(model)
    changed = _same_bits(torch, model, bits)
    if changed:
        raise AssertionError(f"calibration changed the model: {changed[:8]}")
    errors = ([r["op"] for r in rows if "error" in r]
              + [o.op for o in report.ops if o.error or
                 not o.measured_us > 0])
    if failures or errors:
        raise AssertionError(f"measurement failures on flagship ops: "
                             f"{failures} {errors}")
    measured_us = k1.summary()["p50_step_ms"] * 1e3
    profile, history = refit(model, measured_us, report.ops, rounds=3,
                             tol=0.15)
    converged = abs(history[-1].ratio - 1.0) <= 0.15
    if not converged:
        raise AssertionError(f"refit did not converge: "
                             f"{[h.to_dict() for h in history]}")
    if (profile.chip, profile.backend) != ("h100-sxm", "gpu"):
        raise AssertionError(f"profile keyed {profile.chip}/"
                             f"{profile.backend}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cost_")
    path = profile.save(os.path.join(tmp, "fitted_profile.json"))
    cfg = dataclasses.replace(model.config, fitted_profile_file=path)
    fitted = make_machine_model(cfg, 1)
    repriced = Simulator(fitted, cfg).simulate(model.graph, {})
    if abs(repriced / history[-1].predicted_step_us - 1.0) > 1e-6:
        raise AssertionError(f"reloaded profile prices {repriced} us, refit "
                             f"ended at {history[-1].predicted_step_us}")
    selections = {f: dict(zip(("impl", "reason"), (c.impl, c.reason)))
                  for f in sorted(set(OPTYPE_FAMILY.values()))
                  for c in [KERNELS.select(f, config=cfg, record=False)]}
    # drift over more steps of the same run, against the refit prediction
    # (flagged: the detector's verdict, a breach outlasting its patience)
    breaches = REGISTRY.counter("ff_drift_breaches_total", "")
    before = breaches.value()
    det = DriftDetector(repriced)
    verdicts = []
    observe = det.observe
    det.observe = lambda us: verdicts.append(observe(us)) or verdicts[-1]
    model.fit(x, y, batch_size=b, epochs=steps, drift_detector=det)
    if any(verdicts):
        raise AssertionError(f"drift flagged on an unchanged run: "
                             f"verdicts {verdicts}, drift {det.drift}")
    dot = os.path.join(tmp, "task_graph.dot")
    model._export_task_graph(dot)
    text = open(dot).read()
    nodes = re.findall(r'^  n(\d+) \[label="([^"]*)"', text, re.M)
    edges = re.findall(r"^  n(\d+) -> n(\d+);", text, re.M)
    if (len(nodes) != len(model.graph.ops)
            or len(edges) != len(model.graph.edges())
            or not all("fwd=" in lab for _, lab in nodes)):
        raise AssertionError(f"task graph: {len(nodes)} nodes, {len(edges)} "
                             f"edges for {len(model.graph.ops)} ops")
    sweep = _crossover_sweep(torch)
    top = [{k: r[k] for k in ("op", "type", "forward_us", "eff_tflops")}
           for r in rows[:5]]
    del model
    return {
        "phase": "cost", "steps": steps, "warmup_steps": warmup,
        "k1": k1.summary(), "k4": k4,
        "stepstats_mfu_median": stats_mfu,
        "train_formula_mfu_same_steps": formula_mfu,
        "train_phase_mfu": train["mfu_bf16_peak"],
        "flops_per_step": {"stepstats": k1.flops_per_step,
                           "train_formula": train_step_flops(**TRAIN)},
        "peak_tflops": k1.peak_tflops,
        "predicted_step_us_analytic": report.predicted_step_us,
        "predicted_step_us_measured_ops": sim_measured_us,
        "measured_step_us_p50": measured_us,
        "ratio_before": report.step_ratio,
        "refit_rounds": [h.to_dict() for h in history],
        "converged": converged,
        "coefficients": profile.coefficients.to_dict(),
        "op_family_residuals": profile.op_family_residuals,
        "kernel_candidates": report.kernel_candidates(),
        "registry_from_profile": selections,
        "top5_ops": top, "ops_profiled": len(rows),
        "cost_cache": {"hits": measured.hits, "misses": measured.misses,
                       "failures": len(measured.failures)},
        "drift": {"predicted_step_us": repriced, "observed": det._seen,
                  "ema_us": det.measured_step_us, "drift": det.drift,
                  "flagged": sum(verdicts),
                  "breaches": breaches.value() - before},
        "task_graph": {"nodes": len(nodes), "edges": len(edges)},
        "crossover": sweep,
    }


def _slots_serve(torch, cb, prompts, news, vocab):
    """Warm `cb`'s slots 0-15 (its decode graph and 16 chunk graphs), then
    serve the serve phase's 16 requests, timed; returns the tokens, the
    wall, the TTFTs, the graph counts of the timed run and its mean ms a
    decode iteration."""
    import numpy as np

    warm_rng = np.random.RandomState(1)
    cb.start()
    for r in [cb.submit(warm_rng.randint(0, vocab, size=40), 4)
              for _ in range(len(prompts))]:
        r.result(timeout=600)
    warm_stats = cb.stats()
    warm = dict(warm_stats["graphs"])
    t0 = time.perf_counter()
    reqs = [cb.submit(p, int(n)) for p, n in zip(prompts, news)]
    outs = [r.result(timeout=900).tolist() for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cb.stop()
    stats = cb.stats()
    timed = {k: v - warm[k] for k, v in stats["graphs"].items()}
    return (outs, wall, [r.ttft_s for r in reqs], warm, timed,
            _timed_decode_ms(warm_stats, stats))


def _timed_decode_ms(before, after):
    """Mean ms a decode iteration between two `stats()` of one batcher:
    the timed run's own, without the warm-up's (whose first iteration
    captures the decode graph)."""
    def total_s(st):
        return (st["decode_iter_s_mean"] or 0.0) * st["decode_iterations"]

    iters = after["decode_iterations"] - before["decode_iterations"]
    return (total_s(after) - total_s(before)) / iters * 1e3 if iters \
        else None


def _decode_at_slots(torch, slots, m, h, d):
    """decode_attention (C = 1) at the derived batcher's shape: `slots`
    rows at positions spread from an empty slot (0) to a full one
    (m - 1), bf16 and f32, each against decode_attention_plain within
    DECODE_TOL; returns {dtype: row}."""
    from flexflow_tpu_torch.kernels import decode

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    pos = torch.linspace(0, m - 1, slots, device=dev).round().to(torch.int32)
    scale = 1.0 / d ** 0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, kc, vc = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((slots, 1, h, d), (slots, m, h, d),
                                   (slots, m, h, d)))
        out = decode.decode_attention(q, kc, vc, pos, scale=scale,
                                      block_k=512)
        ref = decode.decode_attention_plain(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        a, r = DECODE_TOL[name]
        plan = decode.decode_plan(slots, 1, m, h, d, 512, dtype, dtype)
        rows[name] = {
            "shape": f"B={slots} C=1 M={m} h={h} d={d} {name}",
            "route": plan.route, "max_abs_err": float(err.max()),
            "tolerance": f"|err| <= {a} + {r}*|plain|"}
        if not bool((err <= a + r * ref.float().abs()).all()):
            raise AssertionError(f"slots: decode_attention disagrees with "
                                 f"its plain version: {rows[name]}")
    return rows


def _decode_iteration_probs(torch, cb, prompts, firsts, page, max_len):
    """One decode iteration of batcher `cb` (its captured graph, all
    num_slots rows): slot i holds prompt i (prefilled through its chunk
    graph) and decodes its first token `firsts[i]` at position len(prompt
    i); the other slots decode at positions spread over the cache. Each
    prompt's distribution is then held against the one-slot chunk path
    over prompt + [first token] (slot 0's chunk graph, the multi-query
    kernel at B = 1): the largest |p - q| over the peak of q, a request."""
    import numpy as np

    S = cb.num_slots
    host = np.zeros(3 * S, np.int32)
    host[S:2 * S] = np.linspace(0, max_len - 1, S).round().astype(np.int32)
    with torch.no_grad():
        for slot, prompt in enumerate(prompts):
            for off in range(0, len(prompt), page):
                n = min(page, len(prompt) - off)
                chunk = np.zeros(page + 1, np.int32)
                chunk[:n] = prompt[off:off + n]
                chunk[page] = off
                cb._chunk_dispatch(slot, chunk)
            host[slot], host[S + slot] = firsts[slot], len(prompt)
        cb._decode_dispatch(host)
        dec = cb._dec_probs.float().cpu().clone()
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("slots: non-finite decode probabilities")
    ref = _first_token_probs(torch, cb, [np.append(p, t).astype(np.int32)
                                         for p, t in zip(prompts, firsts)],
                             page)
    return [float((dec[i] - q).abs().max()) / float(q.max())
            for i, q in enumerate(ref)]


def phase_slots(torch, lm, max_len, page, vocab, prompts, news, serve,
                serve_probs):
    """Phase 34: the serve LM's ContinuousBatcher(num_slots=None) on the
    serve phase's 16 requests; tokens against a batcher given that count,
    first-token probabilities against the 8-slot run's; the f32 witness
    (1 layer, hidden 64) against the CPU's tokens."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.search.machine_model import make_machine_model
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
    from flexflow_tpu_torch.serving.sched.kvpool import (derive_num_slots,
                                                         kv_bytes_per_token,
                                                         kv_cache_spec)

    machine = make_machine_model(lm.config, 1)
    unclamped = derive_num_slots(lm, max_len, machine, max_slots=sys.maxsize)
    clamped = derive_num_slots(lm, max_len, machine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    cb = ContinuousBatcher(lm, max_len=max_len, num_slots=None,
                           page_size=page)
    slots = cb.num_slots
    outs, wall, ttft, warm, timed, decode_ms = _slots_serve(
        torch, cb, prompts, news, vocab)
    launches = launch_counts()
    stats = cb.stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if timed["replays"] == 0 or any(timed[k] for k in
                                    ("warmups", "captures", "eager_walks")):
        raise AssertionError(f"slots: the timed run must only replay "
                             f"(warm-up {warm}, timed {timed})")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"slots: kernels never launched: {missing}")
    probs = _first_token_probs(torch, cb, prompts, page)
    worst = max(float((p - q).abs().max()) / float(q.max())
                for p, q in zip(probs, serve_probs))
    if worst > 0.05:
        raise AssertionError(f"slots: first-token probabilities "
                             f"{worst:.3g} x max from the 8-slot run's")
    # the decode kernel at B = slots: alone against its plain version, and
    # the batcher's decode iteration against the one-slot chunk path
    spec = kv_cache_spec(lm)[0]
    kernel_rows = _decode_at_slots(torch, slots, max_len, spec[1], spec[2])
    decode_errs = _decode_iteration_probs(torch, cb, prompts,
                                          [o[0] for o in outs], page, max_len)
    if max(decode_errs) > 0.05:
        raise AssertionError(f"slots: decode-iteration probabilities at "
                             f"{slots} slots {max(decode_errs):.3g} x max "
                             f"from the one-slot chunk path's")
    del cb
    explicit = ContinuousBatcher(lm, max_len=max_len, num_slots=slots,
                                 page_size=page)
    outs_explicit = _slots_serve(torch, explicit, prompts, news, vocab)[0]
    del explicit
    if outs_explicit != outs:
        diff = sum(a != b for a, b in zip(outs, outs_explicit))
        raise AssertionError(f"slots: {diff} of 16 requests' tokens differ "
                             f"from a batcher given num_slots={slots}")

    def witness(device):
        m = build_tiny_lm(8, 64, vocab=vocab, hidden=64, heads=4, layers=1,
                          mixed_precision=False, device=device,
                          generator=torch.Generator().manual_seed(5))
        rng = np.random.RandomState(9)
        work = [(rng.randint(0, vocab, size=n).astype(np.int32), 12)
                for n in (5, 17, 33, 60)]
        with ContinuousBatcher(m, max_len=128, num_slots=None,
                               page_size=page) as wb:
            toks = [r.result(timeout=600).tolist()
                    for r in [wb.submit(p, n) for p, n in work]]
            return toks, wb.num_slots

    card_toks, card_slots = witness("cuda")
    cpu_toks, cpu_slots = witness("cpu")
    if card_toks != cpu_toks:
        raise AssertionError(f"slots f32 witness: card tokens differ from "
                             f"the CPU's ({card_slots} / {cpu_slots} "
                             f"slots)")
    ttft_ms = np.array(ttft) * 1e3
    generated = int(sum(len(o) for o in outs))
    return {
        "phase": "slots", "num_slots": slots,
        "derived_clamped": clamped, "derived_unclamped": unclamped,
        "band_slots": clamped - slots,
        "kv_bytes_per_token": kv_bytes_per_token(lm),
        "machine_budget_gb": machine.memory_budget_bytes() / 1e9,
        "requests": len(outs), "generated_tokens": generated,
        "wall_s": wall, "tokens_per_s": generated / wall,
        "ttft_ms_p50": float(np.percentile(ttft_ms, 50)),
        "ttft_ms_p99": float(np.percentile(ttft_ms, 99)),
        "decode_iter_ms": stats["decode_iter_s_mean"] * 1e3,
        "decode_iter_ms_timed": decode_ms,
        "decode_iterations": stats["decode_iterations"],
        "prefill_chunks": stats["prefill_chunks"],
        "graphs_warmup": warm, "graphs_timed": timed,
        "eight_slot_run": {k: serve[k] for k in (
            "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "decode_iter_ms",
            "decode_iter_ms_timed")},
        "tokens_equal_explicit_count": True,
        "first_token_probs_max_rel_err": worst,
        "decode_kernel_at_slots": kernel_rows,
        "decode_iteration_probs_max_rel_err": max(decode_errs),
        "f32_witness": {"card_slots": card_slots, "cpu_slots": cpu_slots,
                        "tokens_equal": True},
        "decode_routes": {k: launches[k] for k in launches
                          if k.startswith(("decode_attention/",
                                           "multiquery_decode_attention/"))},
        "launches": launches,
        "peak_mem_gib": peak,
    }


def _prefill_probs(torch, model, prompt, chunk, max_len):
    """First-token distribution of `prompt`, prefilled chunk by chunk into
    fresh one-slot caches through the executor (the batcher's path)."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched.kvpool import kv_cache_spec

    caches = {name: {var: torch.zeros((1, max_len, h, d), dtype=cdt,
                                      device=model.device)
                     for var in ("k_cache", "v_cache")}
              for name, h, d, _, cdt in kv_cache_spec(model)}
    name = model.input_ops[0].name
    for off in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - off)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[off:off + n]
        vals = model.executor.forward_values(
            {name: torch.from_numpy(toks).to(model.device)}, state=caches,
            decode_pos=off)
    return vals[model.final_tensor.guid][0, n - 1].float().cpu()


# phases 36-41: the other mesh axes, on four ranks sharing cuda:0 (gloo,
# host-staged), each leg's model at full width (depth cut as listed), 3
# steps (the row pair: 4, two K = 2 dispatches), the last step counted
AXES_RANKS = 4
AXES_LEGS = ("seq-ring", "seq-ulysses", "expert", "row", "attr", "stage")
# the kernels each leg's counted step must launch (on the tensor cores
# where a flash kernel runs)
AXES_KERNELS = {
    "seq-ring": ("layernorm_fwd", "layernorm_bwd", "softmax_fwd",
                 "softmax_bwd", "reduce", "optimizer_adam"),
    "seq-ulysses": ("flash_fwd", "flash_bwd", "flash_fwd/tc",
                    "flash_bwd/tc", "layernorm_fwd", "layernorm_bwd",
                    "softmax_fwd", "softmax_bwd", "reduce",
                    "optimizer_adam"),
    "expert": ("softmax_fwd", "softmax_bwd", "layernorm_fwd",
               "layernorm_bwd", "reduce", "optimizer_adam"),
    "row": ("flash_fwd_blhd", "flash_bwd_blhd", "layernorm_fwd",
            "layernorm_bwd", "softmax_fwd", "softmax_bwd", "reduce",
            "optimizer_adam"),
    "attr": ("softmax_fwd", "softmax_bwd", "reduce", "optimizer_adam"),
    "stage": ("flash_fwd", "flash_bwd", "layernorm_fwd", "layernorm_bwd",
              "softmax_fwd", "softmax_bwd", "reduce", "optimizer_adam"),
}
# each leg's depth cut (the whole script keeps inside its time)
AXES_CUTS = {
    "seq-ring": "12 -> 2 encoder layers",
    "seq-ulysses": "12 -> 2 encoder layers",
    "expert": "none (the switch transformer's 2 layers)",
    "row": "12 -> 2 encoder layers",
    "attr": "none (ResNet-50)",
    "stage": "none (12 encoder layers, 3 a stage)",
}


def _row_strategy(path, layers):
    """The row leg's imported plan: every op of the flagship cut to
    `layers` layers at dp 2 x tp 2, each FFN's second linear (ff2)
    row-parallel, so each FFN is a Megatron pair."""
    from flexflow_tpu_torch.tools.tp_train import JOB, _encoder_graph

    from flexflow_tpu_torch.search.simulator import TP_CAPABLE

    model = _encoder_graph(dict(JOB, widths={"num_layers": layers}), "cpu")
    ops = {op.name: {"dp": 2, "tp": 2 if op.op_type in TP_CAPABLE else 1,
                     "ep": 1, "ap": 1, "tp_row": op.name.endswith("_ff2")}
           for op in model.ops}
    with open(path, "w") as f:
        json.dump({"mesh_axes": {"data": 2, "model": 2}, "cost_us": 0.0,
                   "memory_bytes": 0.0, "ops": ops}, f)


def _axes_jobs(tmp):
    """Phases 36-41's jobs (flexflow_tpu_torch/tools/tp_train.py), by
    leg."""
    import numpy as np

    from flexflow_tpu_torch.tools import zoo_train

    x, y = _train_batch()
    enc = {"model": "encoder", "x": x, "y": y, "steps": 3, "count_steps": 1,
           "seed": 0, "mixed": True, "adam": (1e-4, "bfloat16")}
    rng = np.random.RandomState(1)
    x2 = np.concatenate([x, rng.randint(0, TRAIN["vocab"], size=x.shape)
                         .astype(np.int32)])
    y2 = np.concatenate([y, rng.randint(0, 2, size=y.shape)
                         .astype(np.int32)])
    strat = os.path.join(tmp, "row_pairs.json")
    _row_strategy(strat, 2)
    mx, my = zoo_train.batches("moe_switch", 1)
    rx, ry = zoo_train.batches("resnet50", 1)
    return {
        "seq-ring": dict(enc, axes={"seq": 4}, widths={"num_layers": 2}),
        "seq-ulysses": dict(enc, axes={"seq": 4}, widths={"num_layers": 2},
                            sp_mode="ulysses"),
        "expert": dict(enc, model="zoo", widths={"name": "moe_switch"},
                       batch=zoo_train.ZOO["moe_switch"]["batch"],
                       x=mx[0], y=my, axes={"expert": 4}),
        "row": dict(enc, axes=None, widths={"num_layers": 2}, x=x2, y=y2,
                    steps=2, count_steps=1, steps_per_execution=2,
                    config={"import_strategy_file": strat,
                            "num_devices": 4}),
        "attr": dict(enc, model="zoo", widths={"name": "resnet50"},
                     batch=zoo_train.ZOO["resnet50"]["batch"], x=rx[0],
                     y=ry, axes={"data": 2, "attr": 2},
                     config={"enable_attribute_parallel": True}),
        "stage": dict(enc, axes={"stage": 4},
                      widths={"num_layers": TRAIN["layers"]},
                      config={"pipeline_microbatches": 4},
                      checkpoint_dir=os.path.join(tmp, "stage_ckpt"),
                      predict_batch=TRAIN["batch"]),
    }


# phases 43-46 (A8.2 items 1-4) in phase_axes's spawn: the two-tier 2 x 2
# machine of tests/test_torch_collectives.py (SPEC_2x2) on the H100 spec,
# the flagship's depth for each leg, the sweep's sizes and strategies
A82_SPEC = {"chip": "h100-sxm", "tiers": [
    {"name": "ici", "degree": 2, "gbps": 45.0, "links": 2},
    {"name": "dcn", "degree": 2, "gbps": 3.125, "links": 1,
     "latency_us": 10.0}]}
A82_LEGS = ("lowering-explicit", "lowering-gspmd", "reshard", "taso",
            "taso-replay")
A82_CUTS = {"lowering-explicit": "12 -> 2 encoder layers, f32, SGD",
            "lowering-gspmd": "12 -> 2 encoder layers, f32, SGD",
            "reshard": "none (12 encoder layers)",
            "taso": "12 -> 2 encoder layers",
            "taso-replay": "12 -> 2 encoder layers"}
# the lowering legs train under SGD, whose update scales with the synced
# gradient (Adam's hardly does): a sync off by a factor shows in the loss
# and in each weight's update
A82_SGD_LR = 5e-2
# a rewrite of substitutions/tp_rules.json that inserts parallel ops
# (a Replicate and a Combine around the first FFN linear), replayed by
# compile from a strategy file: graph_subst_3_v2.json's GraphXfers match
# no op of the encoder, so the search under it applies none
A82_REPLAY = {"mesh_axes": {"data": 2, "model": 2}, "ops": {},
              "applied_rewrites": [
                  ["xfer:partition_linear_combine_d2",
                   "partition_linear_combine_d2(layer0_ff1)"]]}
A82_KERNELS = ("layernorm_fwd", "layernorm_bwd", "softmax_fwd",
               "softmax_bwd", "reduce", "optimizer_adam")
A82_SWEEP = {"sizes_mb": (0.25, 1.0, 4.0),
             "strategies": ("flat", "rs_ar_ag", "hier_ring"),
             "warmup": 1, "repeats": 3}
# phases 47-49 (A8.2 item 5) in phase_axes's spawn: serving on a data x
# model mesh, the serve LM's widths (phase 4) and its sessions' shape
SERVE_MESH = {"data": 2, "model": 2}
MESH_LM = {"vocab": 30522, "hidden": 1024, "heads": 16, "window": 512}
MESH_SESSION = {"rows": 4, "prompt": 64, "new": 32, "max_len": 1024}
MESH_CUTS = {"mesh-session-f32": "12 -> 2 serve LM layers, f32",
             "mesh-session": "none (12 serve LM layers, bf16)",
             "mesh-infer": "none (12 encoder layers, bf16)"}
# rank 0's launches of one session prefill, one decode step and one
# bucket walk (12 layers): the head-separated causal flash forward on the
# rank's 8 heads, two LayerNorms a layer, the vocabulary softmax
MESH_PER_WALK = {
    "prefill": {"flash_fwd_blhd": 12, "layernorm_fwd": 24,
                "softmax_fwd": 1},
    "decode_step": {"decode_attention": 12, "decode_attention/tc": 12,
                    "layernorm_fwd": 24, "softmax_fwd": 1},
    "bucket": {"flash_fwd_blhd": 12, "layernorm_fwd": 24, "softmax_fwd": 1},
}
MESH_INFER_BUCKETS = (1, 4, 8)


def _a82_jobs(tmp):
    """Phases 43-46's jobs (tools/tp_train.py), by leg."""
    x, y = _train_batch()
    spec = os.path.join(tmp, "machine_2x2.json")
    with open(spec, "w") as f:
        json.dump(A82_SPEC, f)
    subs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "substitutions")
    rules = os.path.join(subs, "graph_subst_3_v2.json")
    replay = os.path.join(tmp, "replay_strategy.json")
    with open(replay, "w") as f:
        json.dump(A82_REPLAY, f)
    enc = {"model": "encoder", "x": x, "y": y, "seed": 0, "mixed": True,
           "adam": (1e-4, "bfloat16"), "steps": 3, "count_steps": 1}
    low = dict(enc, axes={"data": 4}, widths={"num_layers": 2},
               mixed=False, optimizer=("sgd", A82_SGD_LR),
               update_norms=True)
    return {
        "lowering-explicit": dict(low, config={
            "machine_model_file": spec, "collective_lowering": "explicit"}),
        "lowering-gspmd": dict(low, config={
            "machine_model_file": spec, "collective_lowering": "gspmd"}),
        "reshard": dict(enc, axes={"data": 4}, steps=2,
                        widths={"num_layers": TRAIN["layers"]},
                        reshard_to={"data": 2, "model": 2},
                        reshard_peak=64 << 20),
        "taso": dict(enc, axes=None, steps=2, widths={"num_layers": 2},
                     parallel_chain=2, config={
                         "search_budget": SEARCH_BUDGET,
                         "measure_op_costs": False,
                         "substitution_json_path": rules}),
        "taso-replay": dict(enc, axes=None, steps=2,
                            widths={"num_layers": 2}, config={
                                "import_strategy_file": replay,
                                "substitution_json_path": os.path.join(
                                    subs, "tp_rules.json")}),
        "sweep": {"collective_sweep": dict(A82_SWEEP, machine=spec)},
    }


def _stage_checkpoint(runs):
    """42: the stage leg's checkpoint against JAX's stacked layout (the
    keys `flexflow_tpu/runtime/executor.py _pp_key` gives, built here
    from the port's pipeline plan of the same graph), its restore's
    weights, Adam moments and predictions."""
    import numpy as np

    from flexflow_tpu_torch.core.graph import Graph
    from flexflow_tpu_torch.parallel.pipeline_plan import find_pipeline_plan
    from flexflow_tpu_torch.tools.tp_train import JOB, _encoder_graph

    model = _encoder_graph(dict(JOB, widths={"num_layers": TRAIN["layers"]}),
                           "cpu")
    plan = find_pipeline_plan(Graph(model.ops), 4)
    k = plan.segs_per_stage
    region = {op.name for group in plan.segments for op in group}
    weights = [f"{op.name}/{ws.name}" for op in model.ops
               if op.specs and op.name not in region for ws in op.specs]
    weights += [f"__pipeline__/seg{j}_op{r}_{t.name}/{ws.name}"
                for j in range(k) for r, t in enumerate(plan.segments[j])
                for ws in t.specs]
    want = sorted([f"params/{w}" for w in weights]
                  + [f"opt_state/{g}/{w}" for g in ("m", "v")
                     for w in weights]
                  + ["opt_state/lr", "opt_state/step", "__meta__"])
    first = runs[0]
    if first["checkpoint_keys"] != want:
        missing = sorted(set(want) - set(first["checkpoint_keys"]))[:5]
        extra = sorted(set(first["checkpoint_keys"]) - set(want))[:5]
        raise AssertionError(f"stage checkpoint keys: missing {missing}, "
                             f"unexpected {extra}")
    for j, r in enumerate(runs):
        if not r["restored_state_equal"]:
            raise AssertionError(f"stage checkpoint: rank {j}'s restored "
                                 "weights or Adam moments differ")
        if not np.array_equal(r["restored_predict"], r["predict"]):
            raise AssertionError(f"stage checkpoint: rank {j}'s restored "
                                 "predictions differ")
    return {"phase": "stage-checkpoint", "axes": {"stage": 4},
            "arrays": len(want) - 1,
            "stacked_params": sum(w.startswith("__pipeline__/")
                                  for w in weights),
            "restored_step": first["restored_step"],
            "save_s_by_rank": [r["save_s"] for r in runs],
            "restore_s_by_rank": [r["restore_s"] for r in runs],
            "tolerance": "keys = JAX's stacked layout; restored weights "
                         "and Adam moments, and predict, to the bit"}


def _one_device_losses(torch, job):
    """The leg's model on one card (cuda:0, this process), from the same
    seed's weights and batch: its per-step losses."""
    import gc

    from flexflow_tpu_torch.tools.tp_train import JOB, build_encoder

    job = {**JOB, **job, "axes": {}}
    config = {k: v for k, v in job.get("config", {}).items()
              if k not in ("import_strategy_file", "num_devices")}
    model = build_encoder(dict(job, config=config), "cuda")
    k = job.get("steps_per_execution", 1)
    model.fit(job["x"], job["y"], batch_size=job["batch"],
              epochs=job["steps"], steps_per_execution=k)
    # a record a step, or a K-step dispatch's mean (as the ranks report)
    losses = [r["loss"] for r in model.step_stats.records()]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def phase_axes(torch):
    """36-49: the six mesh legs, the A8.2 legs and the mesh-serving legs
    in one spawn of four ranks (see the module docstring). Returns one
    record a leg and rank 0's launches over each leg's counted step or
    walk."""
    import gc
    import tempfile

    import numpy as np

    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = _axes_jobs(tmp)
        a82 = _a82_jobs(tmp)
        serve = _serve_mesh_jobs()
        t0 = time.perf_counter()
        ranks = spawn_jobs(AXES_RANKS, "cuda",
                           list(jobs.values()) + list(a82.values())
                           + list(serve.values()), timeout_s=1200)
        wall = time.perf_counter() - t0
        records, launches = [], {}
        for i, (leg, job) in enumerate(jobs.items()):
            runs = [r["jobs"][i] for r in ranks]
            first = runs[0]
            losses = first["losses"]
            for j, r in enumerate(runs[1:], 1):
                if r["losses"] != losses:
                    raise AssertionError(
                        f"{leg}: rank {j} losses {r['losses']} differ from "
                        f"rank 0's {losses}")
                if r["replicated_digest"] != first["replicated_digest"]:
                    raise AssertionError(f"{leg}: rank {j}'s replicated "
                                         "weights differ from rank 0's")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"{leg}: non-finite loss {losses}")
            t1 = time.perf_counter()
            one = _one_device_losses(torch, job)
            rels = [abs(a - c) / abs(c) for a, c in zip(losses[:3], one)]
            if max(rels) > 2e-2:
                raise AssertionError(f"{leg}: losses {losses[:3]} vs one "
                                     f"device {one[:3]} (relative {rels})")
            counted = {k: v for k, v in first["launches_per_step"].items()
                       if v}
            missing = [k for k in AXES_KERNELS[leg] if not counted.get(k)]
            if missing:
                raise AssertionError(f"{leg}: kernels never launched in the "
                                     f"counted step: {missing}")
            if leg == "seq-ulysses" and (
                    counted["flash_fwd/tc"] != counted["flash_fwd"]):
                raise AssertionError(f"{leg}: flash calls off the tensor "
                                     f"cores: {counted}")
            plan = first["plan"]
            launches[leg] = {k: int(round(v)) for k, v in counted.items()
                             if "/" not in k}
            records.append({
                "phase": f"axes-{leg}", "axes": plan["axes"],
                "depth_cut": AXES_CUTS[leg],
                "world_size": ranks[0]["host"]["process_count"],
                "backend": ranks[0]["host"]["backend"],
                "host_staging": ranks[0]["host"]["host_staging"],
                "losses": losses, "one_device_losses": one,
                "one_device_s": time.perf_counter() - t1,
                "max_relative_diff_first3": max(rels),
                "launches_per_step": counted,
                "staged_per_step_rank0": first["staged_per_step"],
                "staged_mib_per_step_by_rank": [
                    r["staged_per_step"]["bytes"] / 2 ** 20 for r in runs],
                "ms_per_step_rank0": first["ms_per_step"],
                "ms_per_step_note": "four ranks time-sharing one card over "
                                    "a host-staged gloo transport: not a "
                                    "mesh speed",
                "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in runs],
                "params_gib_by_rank": [r["params_gib"] for r in runs],
                "build_s_by_rank": [r["build_s"] for r in runs],
                "roles": {k: v for k, v in first["roles"].items() if v},
                **({"multi_step": first["multi_step"]}
                   if "multi_step" in first else {}),
                "tolerance": "ranks' losses and replicated weights "
                             "identical; |loss - one device| <= 2e-2 "
                             "|one device|, steps 1-3"})
            if leg == "stage":
                records.append(_stage_checkpoint(runs))
        a82_records, a82_launches = _a82_records(
            torch, ranks, len(jobs), a82)
        t1 = time.perf_counter()
        serve_records, serve_launches = _serve_mesh_records(
            torch, ranks, len(jobs) + len(a82), serve)
        # the serving legs' time: their jobs in the spawn (rank 0) and
        # their one-card references here
        serve_records[0]["legs_s"] = time.perf_counter() - t1 + sum(
            ranks[0]["jobs"][len(jobs) + len(a82) + i]["job_s"]
            for i in range(len(serve)))
    records += a82_records + serve_records
    launches.update(a82_launches)
    launches.update(serve_launches)
    records[0]["spawn_wall_s"] = wall
    return records, launches


def _a82_records(torch, ranks, offset, jobs):
    """43-46 from the spawn's results (jobs from `offset` on): the
    explicit grad sync against gspmd, the live reshard, the searched plan
    under the TASO rules, the collective sweep."""
    import numpy as np

    from flexflow_tpu_torch.obs.calibration import CollectiveCalibration
    from flexflow_tpu_torch.obs.refit import fit_collective_coefficients
    from flexflow_tpu_torch.search.machine_model import \
        HierarchicalMachineModel

    res = {leg: [r["jobs"][offset + i] for r in ranks]
           for i, leg in enumerate(jobs)}
    note = ("four ranks time-sharing one card over a host-staged gloo "
            "transport: not a mesh speed")
    records, launches = [], {}
    for leg in A82_LEGS:
        runs = res[leg]
        first = runs[0]
        for j, r in enumerate(runs[1:], 1):
            if r["losses"] != first["losses"]:
                raise AssertionError(f"{leg}: rank {j} losses {r['losses']}"
                                     f" differ from rank 0's "
                                     f"{first['losses']}")
            if r["replicated_digest"] != first["replicated_digest"]:
                raise AssertionError(f"{leg}: rank {j}'s replicated "
                                     "weights differ from rank 0's")
        if not all(np.isfinite(first["losses"])):
            raise AssertionError(f"{leg}: non-finite loss "
                                 f"{first['losses']}")
        counted = {k: v for k, v in first["launches_per_step"].items() if v}
        kernels = (A82_KERNELS if "optimizer" not in jobs[leg]
                   else A82_KERNELS[:-1] + ("optimizer_sgd",))
        missing = [k for k in kernels if not counted.get(k)]
        if not any(k.startswith("flash_fwd") for k in counted):
            missing.append("flash_fwd*")
        if missing:
            raise AssertionError(f"{leg}: kernels never launched in the "
                                 f"counted step: {missing}")
        launches[leg] = {k: int(round(v)) for k, v in counted.items()
                         if "/" not in k}
        records.append({
            "phase": leg, "axes": first["plan"]["axes"],
            "depth_cut": A82_CUTS[leg], "losses": first["losses"],
            "launches_per_step": counted,
            "staged_per_step_rank0": first["staged_per_step"],
            "ms_per_step_rank0": first["ms_per_step"],
            "ms_per_step_note": note,
            "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in runs],
            "build_s_by_rank": [r["build_s"] for r in runs]})
    by = {r["phase"]: r for r in records}
    # 43: explicit against gspmd
    ex, gs = res["lowering-explicit"][0], res["lowering-gspmd"][0]
    sync = ex["plan"].get("grad_sync")
    if sync is None or sync["mode"] != "explicit":
        raise AssertionError(f"lowering-explicit: no explicit lowering "
                             f"({ex['plan'].get('grad_sync')})")
    if sync["executed"] != sync["priced"]:
        raise AssertionError(f"lowering-explicit: executed plan "
                             f"{sync['executed']} != priced "
                             f"{sync['priced']}")
    if sync["decomposed"] < 1:
        raise AssertionError("lowering-explicit: no entry decomposed")
    if "grad_sync" in gs["plan"]:
        raise AssertionError("lowering-gspmd: a lowering was planned")
    rels = [abs(a - b) / abs(b) for a, b in zip(ex["losses"], gs["losses"])]
    if max(rels) > 1e-5:
        raise AssertionError(f"lowering: explicit {ex['losses']} vs gspmd "
                             f"{gs['losses']} (relative {rels})")
    # each weight's SGD update: a sync that divides by the wrong degree
    # moves it by that factor
    if set(ex["update_norms"]) != set(gs["update_norms"]):
        raise AssertionError("lowering: explicit and gspmd updated "
                             "different weights")
    # relative to the weight's own update, or to 1e-4 of the whole
    # update where its gradient is zero in exact arithmetic (the key
    # bias: softmax ignores a shift along the keys)
    total = math.sqrt(sum(v * v for v in gs["update_norms"].values()))
    if not total > 0:
        raise AssertionError("lowering-gspmd: no weight moved")
    upd = {k: abs(ex["update_norms"][k] - v) / max(v, 1e-4 * total)
           for k, v in gs["update_norms"].items()}
    worst = max(upd, key=upd.get)
    if upd[worst] > 1e-3:
        raise AssertionError(f"lowering: {worst}'s update norm explicit "
                             f"{ex['update_norms'][worst]} vs gspmd "
                             f"{gs['update_norms'][worst]}")
    by["lowering-explicit"].update(
        strategies={s: list(sync["executed"].values()).count(s)
                    for s in set(sync["executed"].values())},
        decomposed=sync["decomposed"], buckets=sync["buckets"],
        executed_equals_priced=True, gspmd_losses=gs["losses"],
        max_relative_diff=max(rels), update_norms=len(upd),
        max_update_norm_relative_diff=upd[worst],
        worst_update_norm=[worst, ex["update_norms"][worst],
                           gs["update_norms"][worst]],
        tolerance="executed plan = priced plan, >= 1 entry decomposed; "
                  "under SGD |explicit - gspmd| <= 1e-5 |gspmd| a step's "
                  "loss and <= 1e-3 max(|gspmd|, 1e-4 of the whole update) "
                  "each weight's update norm; "
                  "every leg's replicated weights rank-identical")
    # 44: the live reshard and back
    for j, r in enumerate(res["reshard"]):
        rs = r["reshard"]
        for move in (rs, rs["back"]):
            if move["mismatched"]:
                raise AssertionError(f"reshard: rank {j}'s leaves "
                                     f"{move['mismatched'][:5]} differ from "
                                     "the gathered whole's slices")
            if move["observed_peak_bytes"] > move["planned_scratch_bytes"]:
                raise AssertionError(
                    f"reshard: rank {j} observed {move['observed_peak_bytes']}"
                    f" B > planned {move['planned_scratch_bytes']} B")
        if not all(np.isfinite(rs["losses_after"])) or \
                len(rs["losses_after"]) != 2:
            raise AssertionError(f"reshard: losses after {rs['losses_after']}")
    rs0 = res["reshard"][0]["reshard"]
    if any(r["reshard"]["losses_after"] != rs0["losses_after"]
           for r in res["reshard"]):
        raise AssertionError("reshard: the ranks' losses after differ")
    keys = ("old_axes", "new_axes", "arrays", "noop", "rounds",
            "planned_scratch_bytes", "peak_bytes_bound",
            "observed_peak_bytes", "bytes_moved", "wall_s",
            "transfer_rounds", "allgather_rounds", "staged")
    by["reshard"].update(
        there={k: rs0[k] for k in keys},
        back={k: rs0["back"][k] for k in keys},
        observed_peak_bytes_by_rank=[
            [r["reshard"]["observed_peak_bytes"],
             r["reshard"]["back"]["observed_peak_bytes"]]
            for r in res["reshard"]],
        losses_after=rs0["losses_after"],
        tolerance="every leaf the gathered whole's slice to the bit; "
                  "observed round scratch <= planned, both ways; 2 more "
                  "steps finite and rank-identical")
    # 45: the search under the TASO rules
    taso = res["taso"][0]
    if not taso["plan"]["axes"]:
        raise AssertionError("taso: the searched plan has no mesh axis")
    if not taso["plan"]["parallel_ops"]:
        raise AssertionError("taso: the searched plan holds no parallel op")
    one = _one_device_losses(torch, dict(jobs["taso"], config={}))
    rels = [abs(a - c) / abs(c) for a, c in zip(taso["losses"], one)]
    if max(rels) > 2e-2:
        raise AssertionError(f"taso: losses {taso['losses']} vs one device "
                             f"{one} (relative {rels})")
    by["taso"].update(
        parallel_ops=taso["plan"]["parallel_ops"],
        search=taso["plan"].get("search"), one_device_losses=one,
        max_relative_diff=max(rels),
        tolerance="the layer methods' parallel ops in the plan; ranks' "
                  "losses identical; |loss - one device| <= 2e-2 |one "
                  "device|")
    # 45: a TASO GraphXfer that inserts parallel ops, applied by compile
    rep = res["taso-replay"][0]
    made = {rep["plan"]["parallel_ops"].get(n) for n in
            rep["plan"]["xfer_ops"]}
    if not {"replicate", "combine"} <= made:
        raise AssertionError(f"taso-replay: the rewrite made "
                             f"{rep['plan']['xfer_ops']} ({made})")
    one = _one_device_losses(torch, dict(jobs["taso-replay"], config={}))
    rels = [abs(a - c) / abs(c) for a, c in zip(rep["losses"], one)]
    if max(rels) > 2e-2:
        raise AssertionError(f"taso-replay: losses {rep['losses']} vs one "
                             f"device {one} (relative {rels})")
    by["taso-replay"].update(
        applied_rewrites=A82_REPLAY["applied_rewrites"],
        xfer_ops=rep["plan"]["xfer_ops"], one_device_losses=one,
        max_relative_diff=max(rels),
        tolerance="the rewrite's Replicate and Combine in the plan; ranks' "
                  "losses and replicated weights identical; |loss - one "
                  "device| <= 2e-2 |one device|")
    # 46: the collective sweep, and the per-tier fit on it
    sweep = res["sweep"][0]
    rows = [CollectiveCalibration(**{k: v for k, v in r.items()
                                     if k != "ratio"})
            for r in sweep["rows"]]
    if not rows or not all(r.measured_us > 0 for r in rows):
        raise AssertionError(f"sweep: rows {sweep['rows']}")
    coeffs = fit_collective_coefficients(
        rows, HierarchicalMachineModel.from_json(A82_SPEC))
    if set(coeffs.tier_link_scales) != {"ici", "dcn"}:
        raise AssertionError(f"sweep: per-tier scales "
                             f"{coeffs.tier_link_scales}")
    records.append({
        "phase": "collective-sweep", "tiers": sweep["tiers"],
        "rows": [{k: r[k] for k in ("op", "strategy", "tier", "bytes",
                                    "participants", "predicted_us",
                                    "measured_us")} for r in sweep["rows"]],
        "tier_link_scales": coeffs.tier_link_scales,
        "wall_s": sweep["wall_s"], "staged": sweep["staged"],
        "measured_note": "rank 0's CUDA-event time of each collective, " +
                         note,
        "tolerance": "every row positive; a fitted scale per tier"})
    return records, launches


def _serve_mesh_jobs():
    """Phases 47-49's jobs (tools/tp_train.py `serve_job`), by leg."""
    import numpy as np

    rng = np.random.RandomState(47)
    prompts = rng.randint(0, MESH_LM["vocab"], size=(
        MESH_SESSION["rows"], MESH_SESSION["prompt"])).astype(np.int32)
    lm = {"model": "serve_lm", "batch": MESH_SESSION["rows"], "seed": 0,
          "comp_mode": "inference", "axes": SERVE_MESH}
    session = {"kind": "session", "prompts": prompts,
               "max_len": MESH_SESSION["max_len"],
               "runs": [{"new": MESH_SESSION["new"]}]}
    x, _ = _train_batch()
    return {
        "mesh-session-f32": dict(lm, mixed=False, serve=session,
                                 widths=dict(MESH_LM, layers=2)),
        "mesh-session": dict(lm, mixed=True, widths=dict(MESH_LM,
                                                         layers=12),
                             serve=dict(session, launches=True,
                                        last_probs=True)),
        "mesh-infer": {"model": "encoder", "batch": TRAIN["batch"],
                       "seed": 0, "mixed": True, "comp_mode": "inference",
                       "axes": SERVE_MESH, "serve": {
                           "kind": "infer", "buckets": MESH_INFER_BUCKETS,
                           "x": x, "launches": True,
                           "batcher_rows": TRAIN["batch"],
                           "max_batch": TRAIN["batch"],
                           "delay_ms": 5000.0}},
    }


def _one_card(job):
    """The leg's model on one card (cuda:0, this process), from the same
    seed's weights."""
    from flexflow_tpu_torch.tools.tp_train import JOB, build_encoder

    return build_encoder({**JOB, **{k: v for k, v in job.items()
                                    if k != "serve"}, "axes": {}}, "cuda")


def _serve_mesh_records(torch, ranks, offset, jobs):
    """47-49 from the spawn's results (jobs from `offset` on), each held
    against the same model on one card in this process."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.serving import InferenceModel
    from flexflow_tpu_torch.tools.tp_train import _session

    res = {leg: [r["jobs"][offset + i] for r in ranks]
           for i, leg in enumerate(jobs)}
    note = ("four ranks time-sharing one card over a host-staged gloo "
            "transport: not a mesh speed")
    records, launches = [], {}
    for leg in ("mesh-session-f32", "mesh-session"):
        runs, job = res[leg], jobs[leg]
        toks = runs[0]["runs"][0]["tokens"]
        for j, r in enumerate(runs[1:], 1):
            if not np.array_equal(r["runs"][0]["tokens"], toks):
                raise AssertionError(f"{leg}: rank {j}'s tokens differ "
                                     "from rank 0's")
        st = runs[0]["stats"]
        if st["graph_capture"] or st["graphs"]["captures"] or \
                st["rows"] != MESH_SESSION["rows"] // 2:
            raise AssertionError(f"{leg}: rank 0 stats {st}")
        t1 = time.perf_counter()
        one = _one_card(job)
        card = _session(one, job["serve"], "cuda")
        one_s = time.perf_counter() - t1
        del one
        gc.collect()
        torch.cuda.empty_cache()
        want = card["runs"][0]["tokens"]
        if toks.shape != want.shape or not (
                (toks >= 0) & (toks < MESH_LM["vocab"])).all():
            raise AssertionError(f"{leg}: tokens {toks.shape}")
        agree = int((toks == want).sum())
        rec = {"phase": leg, "axes": SERVE_MESH, "depth_cut": MESH_CUTS[leg],
               "tokens_rank0": toks.tolist(),
               "tokens_agreeing_with_one_card": agree,
               "tokens_total": int(toks.size),
               "session_s_rank0": runs[0]["runs"][0]["s"],
               "session_s_one_card": card["runs"][0]["s"],
               "session_s_note": note, "one_card_build_and_run_s": one_s,
               "staged_rank0": runs[0]["staged"], "stats_rank0": st,
               "build_s_by_rank": [r["build_s"] for r in runs],
               "train_step_built": runs[0]["train_step"],
               "opt_state_built": runs[0]["opt_state"]}
        if leg == "mesh-session-f32":
            if agree != toks.size:
                raise AssertionError(f"{leg}: {agree} of {toks.size} tokens "
                                     f"agree with one card: {toks.tolist()}"
                                     f" vs {want.tolist()}")
            rec["tolerance"] = ("every rank's tokens identical, and "
                                "identical to one card's")
            records.append(rec)
            continue
        p, q = runs[0]["last_probs"], card["last_probs"]
        err = float(np.abs(p - q).max())
        tol = 0.05 * float(q.max())
        if not np.isfinite(p).all() or err > tol:
            raise AssertionError(f"{leg}: prefill probabilities {err} from "
                                 f"one card's (tolerance {tol})")
        got = runs[0]["launches"]
        for walk in ("prefill", "decode_step"):
            seen = {k: got[walk].get(k, 0) for k in MESH_PER_WALK[walk]}
            if seen != MESH_PER_WALK[walk]:
                raise AssertionError(f"{leg}: rank 0's launches of one "
                                     f"{walk} {got[walk]}, expected "
                                     f"{MESH_PER_WALK[walk]}")
        stray = [k for k in ("flash_fwd", "multiquery_decode_attention")
                 if got["prefill"].get(k) or got["decode_step"].get(k)]
        if stray or got["decode_step"].get("flash_fwd_blhd"):
            raise AssertionError(f"{leg}: unexpected launches {got}")
        launches["mesh-session-prefill"] = {
            k: v for k, v in got["prefill"].items() if "/" not in k}
        launches["mesh-session-decode-step"] = {
            k: v for k, v in got["decode_step"].items() if "/" not in k}
        rec.update(prefill_max_abs_err=err, prefill_tolerance=tol,
                   prefill_max_prob=float(q.max()), launches=got,
                   tolerance="every rank's tokens identical; prefill's "
                             "last-position probabilities within 5e-2 of "
                             "max(p) of one card's; launches a walk exact")
        records.append(rec)
    # 49: the flagship's buckets on the mesh, and the leader's batcher
    runs, job = res["mesh-infer"], jobs["mesh-infer"]
    first = runs[0]
    for j, r in enumerate(runs[1:], 1):
        if not np.array_equal(r["predict"], first["predict"]):
            raise AssertionError(f"mesh-infer: rank {j}'s output differs")
        if r["followed"] < 1 or "rank 0" not in r["follower_submit"]:
            raise AssertionError(f"mesh-infer: rank {j} followed "
                                 f"{r['followed']} batches, submit "
                                 f"{r['follower_submit']!r}")
    st = first["stats"]
    if st["graph_capture"] or st["graphs"]["captures"] or \
            st["graphs"]["replays"] or not st["graphs"]["eager_walks"]:
        raise AssertionError(f"mesh-infer: buckets {st}")
    seen = {k: first["launches"].get(k, 0) for k in MESH_PER_WALK["bucket"]}
    if seen != MESH_PER_WALK["bucket"]:
        raise AssertionError(f"mesh-infer: rank 0's launches of a bucket "
                             f"walk {first['launches']}")
    launches["mesh-infer-bucket"] = {
        k: v for k, v in first["launches"].items() if "/" not in k}
    batch_err = float(np.abs(first["batcher"] - first["predict"]).max())
    if batch_err > 1e-6:
        raise AssertionError(f"mesh-infer: the batcher's rows {batch_err} "
                             "from the direct predict")
    t1 = time.perf_counter()
    one = _one_card(job)
    im = InferenceModel(one, batch_buckets=MESH_INFER_BUCKETS)
    x = job["serve"]["x"]
    card = im.predict({im.input_names[0]: x})
    card_stats = im.stats()
    del im, one
    gc.collect()
    torch.cuda.empty_cache()
    err = float(np.abs(first["predict"] - card).max())
    if not np.isfinite(first["predict"]).all() or err > 5e-2 or \
            not card_stats["graphs"]["captures"]:
        raise AssertionError(f"mesh-infer: {err} from the one-card bucket "
                             f"graph ({card_stats})")
    records.append({
        "phase": "mesh-infer", "axes": SERVE_MESH,
        "depth_cut": MESH_CUTS["mesh-infer"], "output": list(card.shape),
        "max_abs_err_vs_one_card_graph": err,
        "batcher_max_abs_err_vs_predict": batch_err,
        "followed_by_rank": [r.get("followed") for r in runs],
        "stats_rank0": st, "one_card_stats": card_stats,
        "launches_rank0": first["launches"],
        "predict_s_rank0": first["predict_s"], "predict_s_note": note,
        "one_card_s": time.perf_counter() - t1,
        "build_s_by_rank": [r["build_s"] for r in runs],
        "tolerance": "eager walks, no capture; |mesh - one-card graph| "
                     "<= 5e-2; the leader's batch within 1e-6 of the "
                     "direct predict; launches a walk exact"})
    return records, launches


def phase_resize(torch, new=(48, 48, 16, 16, 12, 12)):
    """50: the serve LM (full width and depth, f32) in a ContinuousBatcher
    of 8 slots: 6 requests unresized, then the same 6 shrunk to 4 slots
    and grown back to 8 while they decode. Returns the phase's record."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = build_tiny_lm(8, MESH_LM["window"], vocab=MESH_LM["vocab"],
                       hidden=MESH_LM["hidden"], heads=MESH_LM["heads"],
                       layers=12, device="cuda",
                       generator=torch.Generator().manual_seed(50))
    rng = np.random.RandomState(50)
    prompts = [rng.randint(0, MESH_LM["vocab"], size=int(n)).astype(
        np.int32) for n in rng.randint(32, 129, size=len(new))]

    def run(resize):
        cb = ContinuousBatcher(lm, max_len=1024, num_slots=8, page_size=16)
        tickets = []
        with cb:
            reqs = [cb.submit(p, n) for p, n in zip(prompts, new)]
            if resize:
                deadline = time.monotonic() + 300
                while not any(r.tokens for r in reqs):
                    if time.monotonic() > deadline:
                        raise AssertionError("resize: no token in 300 s")
                    time.sleep(0.005)
                before = dict(cb.stats()["graphs"])
                tickets = [cb.request_resize(4).wait(timeout=600),
                           cb.request_resize(8).wait(timeout=600)]
            outs = [r.result(timeout=900) for r in reqs]
            errors = [r.error for r in reqs if r.error is not None]
        stats = cb.stats()
        if resize:
            stats["graphs_before_resize"] = before
        return outs, errors, stats, tickets

    plain, _, _, _ = run(False)
    outs, errors, stats, (shrink, grow) = run(True)
    same = all(np.array_equal(a, b) for a, b in zip(outs, plain))
    if errors or not same or [len(o) for o in outs] != list(new):
        raise AssertionError(f"resize: tokens differ from the unresized "
                             f"run ({same}) or requests failed {errors}")
    if (shrink["direction"], grow["direction"]) != ("shrink", "grow") or \
            not (shrink["migrated_rows"] and grow["migrated_rows"]):
        raise AssertionError(f"resize: {shrink} then {grow}")
    before, after = stats["graphs_before_resize"], stats["graphs"]
    if after["captures"] <= before["captures"]:
        raise AssertionError(f"resize: no graph captured again ({before} -> "
                             f"{after})")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "resize", "model": "serve LM, 12 layers, f32",
            "requests": len(new), "new_tokens": list(new),
            "shrink": shrink, "grow": grow,
            "stats_resizes": stats["resizes"],
            "graphs_before_resize": before, "graphs_after": after,
            "captures_after_resize": after["captures"] - before["captures"],
            "wall_s": time.perf_counter() - t0,
            "tolerance": "every request's tokens equal the unresized "
                         "run's; no request failed; both resizes migrated "
                         "live rows; graphs captured again"}


def mesh_serve_kernels(torch, F, g, table):
    """The ported kernels at the mesh-serving shapes of phases 47-49, bf16,
    against their plain versions and timed beside SDPA and the bound: B7
    causal at the mesh's local shape (4, 512, 8 x 64, blhd), added to the
    flash_fwd_blhd row as `mesh_causal_shape`, and B5 at 8 heads over the
    session's 2 rows a rank (M 1024, both at position 80), added to the
    decode_attention row as `mesh_shape`."""
    from flexflow_tpu_torch.kernels import decode
    from flexflow_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    b, l, h, d = 4, MESH_LM["window"], MESH_LM["heads"] // 2, 64
    scale = d ** -0.5
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    shape = f"b={b} l={l} h={h} d={d} blhd bfloat16 causal"
    o, _ = fa.flash_fwd_heads(q, k, v, scale=scale, causal=True,
                              layout="blhd")
    ro, _ = fa.flash_fwd_heads_plain(q, k, v, scale, True, "blhd")
    row = _agree("flash_fwd_heads (mesh causal)", o, ro, (4e-3, 2e-2),
                 shape)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # the causal product: the score and context products of the
    # attended half, each row its own prefix
    attended = b * h * l * (l + 1) // 2
    bound = _bound(4 * b * l * h * d * 2 + b * h * l * 4,
                   4 * attended * d, "bfloat16")
    row.update(
        ms=_time_ms(torch, lambda: fa.flash_fwd_heads(
            q, k, v, scale=scale, causal=True, layout="blhd")),
        plain_ms=_time_ms(torch, lambda: fa.flash_fwd_heads_plain(
            q, k, v, scale, True, "blhd")),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, is_causal=True)),
        bound_ms=bound[0], bound_by=bound[1],
        library="F.scaled_dot_product_attention(is_causal=True) on "
                "(b, h, l, d)")
    table["flash_fwd_blhd"]["mesh_causal_shape"] = row
    rows, m = MESH_SESSION["rows"] // 2, MESH_SESSION["max_len"]
    at = MESH_SESSION["prompt"] + MESH_SESSION["new"] // 2
    pos = torch.full((rows,), at, dtype=torch.int32, device=dev)
    q = torch.randn((rows, 1, h, d), generator=g, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((rows, m, h, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out = decode.decode_attention(q, kc, vc, pos, scale=scale, block_k=512)
    ref = decode.decode_attention_plain(q, kc, vc, pos, scale)
    dshape = f"B={rows} C=1 M={m} h={h} d={d} bfloat16 (pos {at})"
    drow = _agree("decode_attention (mesh)", out, ref,
                  DECODE_TOL["bfloat16"], dshape)
    mask = (torch.arange(m, device=dev)[None, None, :]
            <= pos.long()[:, None, None])[:, None]          # (B, 1, 1, M)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    nbytes = 2 * rows * (at + 1) * h * d * 2 + 2 * q.numel() * 2 + rows * 4
    dbound = _bound(nbytes, 4 * h * d * rows * (at + 1), "bfloat16")
    drow.update(
        ms=_time_ms(torch, lambda: decode.decode_attention(
            q, kc, vc, pos, scale=scale, block_k=512)),
        plain_ms=_time_ms(torch, lambda: decode.decode_attention_plain(
            q, kc, vc, pos, scale)),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale)),
        bound_ms=dbound[0], bound_by=dbound[1],
        library="F.scaled_dot_product_attention with a bool mask")
    table["decode_attention"]["mesh_shape"] = drow


def ulysses_flash_kernels(torch, F, g, table):
    """B1 at Ulysses' local shape on the seq-ulysses leg: the packed
    kernel at h = 16 / 4 = 4 heads a rank, (8, 512, 4 x 64) bf16, forward
    and backward against their plain versions, timed beside SDPA and the
    bound; added to the flash rows as `ulysses_shape`."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"] // 4, 64
    e, scale = h * d, d ** -0.5
    q, k, v, do = (torch.randn((b, l, e), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    shape = f"b={b} l={l} h={h} d={d} bfloat16 (Ulysses, seq=4)"
    o, lse = fa.flash_fwd(q, k, v, h, scale=scale)
    ro, _ = fa.flash_fwd_plain(q, k, v, h, scale, False)
    fwd = _agree("flash_fwd (ulysses)", o, ro, (4e-3, 2e-2), shape)
    grads = fa.flash_bwd(q, k, v, o, lse, do, h, scale=scale)
    delta = (do.float() * o.float()).reshape(b, l, h, d).sum(-1)
    ref = fa.flash_bwd_plain(q, k, v, do, lse, delta, h, scale, False)
    rows = [_agree(f"flash_bwd (ulysses d{n})", a, r, (1e-3, 1e-2), shape)
            for n, a, r in zip("qkv", grads, ref)]
    bwd = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))
    qt, kt, vt, dot = (t.reshape(b, l, h, d).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    fb = _bound(4 * b * l * e * 2 + b * l * h * 4, 4 * b * h * l * l * d,
                "bfloat16")
    bb = _bound(8 * b * l * e * 2 + 2 * b * l * h * 4,
                10 * b * h * l * l * d, "bfloat16")
    fwd.update(
        ms=_time_ms(torch, lambda: fa.flash_fwd(q, k, v, h, scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, h, scale, False)),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)),
        bound_ms=fb[0], bound_by=fb[1])
    bwd.update(
        ms=_time_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, h,
                                                scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, do, lse, delta, h, scale, False)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
        bound_ms=bb[0], bound_by=bb[1])
    for row in (fwd, bwd):
        row["vs_library"] = row["ms"] / row["library_ms"]
    table["flash_fwd"]["ulysses_shape"] = fwd
    table["flash_bwd"]["ulysses_shape"] = bwd


# phases 51-54: the elastic coordinator (flexflow_tpu_torch/elastic/).
# 51-52: four ranks sharing the card over gloo, the flagship encoder at
# full width cut to 2 of its 12 layers, f32, SGD, the analytic search
ELASTIC_RANKS = 4
ELASTIC_WIDTHS = {"num_layers": 2}
ELASTIC_STEPS = 8
ELASTIC_KERNELS = ("flash_fwd", "flash_bwd", "layernorm_fwd",
                   "layernorm_bwd", "softmax_fwd", "softmax_bwd", "reduce",
                   "optimizer_sgd")
# 53: one card, the flagship at full depth, bf16, Adam
NAN_WIDTHS = {"num_layers": 12}
ELASTIC_NAN_KERNELS = ("flash_fwd", "flash_bwd", "layernorm_fwd",
                       "layernorm_bwd", "softmax_fwd", "softmax_bwd",
                       "reduce", "optimizer_adam")
# the JAX package's event order of its NaN scenario (tests/
# test_watchdog.py; tests/test_torch_elastic.py holds the port to it)
NAN_EVENTS = [
    ("checkpoint", 0), ("checkpoint", 2), ("fault.nan_step", 3),
    ("watchdog.bad_step", 3), ("watchdog.skip", 3), ("fault.nan_step", 4),
    ("watchdog.bad_step", 4), ("watchdog.skip", 4), ("fault.nan_step", 5),
    ("watchdog.bad_step", 5), ("recovery.restore", 2),
    ("watchdog.rollback", 2), ("checkpoint", 4), ("checkpoint.gc", 0),
    ("checkpoint", 6), ("fault.nan_step", 6), ("watchdog.bad_step", 6),
    ("watchdog.skip", 6), ("checkpoint.gc", 2), ("checkpoint", 8)]


def _elastic_batches(n_batches=4):
    """Four batches of bench.py's shape: tokens and labels from
    RandomState(0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x = rng.randint(0, TRAIN["vocab"],
                    size=(b * n_batches, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(b * n_batches, seq, 1)).astype(np.int32)
    return x, y


def _elastic_jobs(tmp):
    """51-52's jobs (tools/tp_train.py `elastic`): the live recovery, the
    uninterrupted reference (on every rank: the lost ones came back),
    the poisoned live tree with ranks 0 and 1 lost, and the torn
    checkpoint with live resharding off."""
    x, y = _elastic_batches()

    def job(tag, faults, **coordinator):
        return {"elastic": {
            "model": "encoder", "widths": dict(ELASTIC_WIDTHS),
            "batch": TRAIN["batch"], "mixed": False,
            "optimizer": ("sgd", 0.01), "accuracy": True,
            "config": {"search_budget": 4, "measure_op_costs": False},
            "faults": faults, "x": x, "y": y, "steps": ELASTIC_STEPS,
            "checkpoint_dir": os.path.join(tmp, tag),
            "retry": {"max_retries": 3, "base_delay_s": 0.01},
            "coordinator": dict({"checkpoint_every": 2}, **coordinator),
            "preplan_join": True, "step_launches": True}}

    return {"live": job("live", [("transient", 1, (), 1),
                                 ("chip_loss", 3, (2, 3), 1)]),
            "ref": job("ref", []),
            "disk": job("disk", [("poison_live_state", 3, (), 1),
                                 ("chip_loss", 3, (0, 1), 1)]),
            "torn": job("torn", [("corrupt_checkpoint", 4, (), 1),
                                 ("chip_loss", 4, (2, 3), 1)],
                        live_resharding=False)}


def _events(run, kind):
    return [e for e in run["events"] if e[0] == kind]


def _elastic_leader(runs):
    alive = [r for r in runs if not r["departed"]]
    lead = alive[0]["device_ids"][0]
    return next(r for r in alive if r["rank"] == lead)


def _step_after(run, step):
    """Launches of one step after `step`'s verdict: the update of step
    `step` and the walk of the next (tools/tp_train.py StepProbe)."""
    counts = run["step_launches"]
    i = next(i for i, (s, _) in enumerate(counts) if s == step)
    (_, a), (_, b) = counts[i], counts[i + 1]
    return {k: b[k] - a.get(k, 0) for k in b if b[k] - a.get(k, 0)
            and "/" not in k}


def _elastic_check(name, runs, lost, at):
    """The checks every recovery run shares: the lost ranks left at the
    loss, every survivor committed every step once with the same losses
    to the bit, every loss finite, every kernel of the path launched on
    rank 0 of the survivors."""
    import numpy as np

    lead = _elastic_leader(runs)
    for r in runs:
        if r["rank"] in lost:
            if r["departed"] != {"step": at, "lost_chips": list(lost)}:
                raise AssertionError(f"{name}: rank {r['rank']} did not "
                                     f"leave at step {at}: {r['departed']}")
            continue
        if [h["step"] for h in r["history"]] != list(range(ELASTIC_STEPS)):
            raise AssertionError(f"{name}: rank {r['rank']} committed "
                                 f"{[h['step'] for h in r['history']]}")
        if [h["loss"] for h in r["history"]] != \
                [h["loss"] for h in lead["history"]]:
            raise AssertionError(f"{name}: rank {r['rank']}'s losses "
                                 "differ from the leader's")
    losses = [h["loss"] for h in lead["history"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    first = min(r["rank"] for r in runs if not r["departed"])
    launched = next(r for r in runs if r["rank"] == first)["launches"]
    missing = [k for k in ELASTIC_KERNELS if not launched.get(k)]
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the "
                             f"recovered run: {missing}")
    return lead, losses


def phase_elastic(torch):
    """51-52 in one spawn of four ranks sharing the card (see the module
    docstring). Returns the two records and rank 0's launches by run."""
    import gc
    import tempfile

    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = _elastic_jobs(tmp)
        t0 = time.perf_counter()
        ranks = spawn_jobs(ELASTIC_RANKS, "cuda", list(jobs.values()),
                           timeout_s=900)
        wall = time.perf_counter() - t0
    runs = {tag: [r["jobs"][i] for r in ranks]
            for i, tag in enumerate(jobs)}
    ref = runs["ref"]
    if any(r["departed"] for r in ref) or \
            len({tuple(h["loss"] for h in r["history"]) for r in ref}) != 1:
        raise AssertionError("ref: every rank (the returned ones too) must "
                             "train the same 8 steps")
    ref_losses = [h["loss"] for h in ref[0]["history"]]
    # 51: transient, then ranks 2 and 3 lost: a live recovery
    lead, losses = _elastic_check("elastic-live", runs["live"], (2, 3), 3)
    restore = _events(lead, "recovery.restore")
    search = _events(lead, "recovery.search")
    reads = {r["rank"]: sum(r["checkpoint_counts"].get(k, 0) for k in
                            ("restored", "verified", "corrupt"))
             for r in runs["live"] if not r["departed"]}
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    checks = {
        "retry_absorbed": len(_events(lead, "fault.transient")) == 1
        and len(_events(lead, "retry")) == 1,
        "replan_on_2": bool(search) and search[0][2]["n_devices"] == 2,
        "live_restore": len(restore) == 1
        and restore[0][2]["source"] == "live",
        "no_checkpoint_read": not any(reads.values()),
        "resumed_at_3": bool(restore) and restore[0][1] == 3,
        "ref_within_1e-4": max(rels) <= 1e-4,
    }
    if not all(checks.values()):
        raise AssertionError(f"elastic-live: {checks}; events "
                             f"{[e[:2] for e in lead['events']]}")
    launches = {"elastic-live": lead["launches"]}
    live = {
        "phase": "elastic-live", "ranks": ELASTIC_RANKS,
        "widths": ELASTIC_WIDTHS, "dtype": "float32", "optimizer": "sgd",
        "axes_before": runs["live"][2]["axes"], "axes_after": lead["axes"],
        "device_ids_after": lead["device_ids"], "checks": checks,
        "losses": losses, "ref_losses": ref_losses,
        "max_relative_diff_vs_ref": max(rels),
        "reshard": lead["reshard"],
        "restore_ms": restore[0][2]["restore_ms"],
        "replan_ms": search[0][2]["replan_ms"],
        "search_cache": search[0][2]["cache"],
        "first_step_after_recovery_launches_rank0": _step_after(lead, 3),
        "fit_s_by_rank": [r["fit_s"] for r in runs["live"]],
        "ref_fit_s": ref[0]["fit_s"], "spawn_wall_s": wall,
        "departed": {r["rank"]: r["departed"] for r in runs["live"]
                     if r["departed"]},
        "tolerance": "survivors' losses equal to the bit; |loss - "
                     "uninterrupted| <= 1e-4 |uninterrupted|"}
    # 52: poisoned live tree, ranks 0 and 1 lost; then a torn checkpoint
    lead, losses = _elastic_check("elastic-disk", runs["disk"], (0, 1), 3)
    fb = _events(lead, "recovery.live_fallback")
    restore = _events(lead, "recovery.restore")
    checks = {
        "fallback_verify": len(fb) == 1 and fb[0][2]["reason"] == "verify",
        "disk_restore_step_2": len(restore) == 1 and restore[0][1] == 2
        and restore[0][2]["source"] == "disk",
        "rank2_leads": lead["rank"] == 2 and lead["search_leader"] == 2,
        "rank2_writes": lead["written"] == [4, 6],
    }
    t_lead, _ = _elastic_check("elastic-torn", runs["torn"], (2, 3), 4)
    t_fb = _events(t_lead, "checkpoint.fallback")
    t_restore = _events(t_lead, "recovery.restore")
    checks.update({
        "torn_corrupt": len(_events(t_lead, "checkpoint.corrupt")) == 1,
        "torn_fallback_step_2": [e[1] for e in t_fb] == [2]
        and bool(t_restore) and t_restore[0][1] == 2,
    })
    if not all(checks.values()):
        raise AssertionError(f"elastic-disk: {checks}")
    launches["elastic-disk"] = lead["launches"]
    launches["elastic-torn"] = t_lead["launches"]
    disk = {
        "phase": "elastic-disk", "checks": checks, "losses": losses,
        "restore_ms": restore[0][2]["restore_ms"],
        "torn_restore_ms": t_restore[0][2]["restore_ms"],
        "device_ids_after": lead["device_ids"], "axes_after": lead["axes"],
        "torn_losses": [h["loss"] for h in t_lead["history"]],
        "fit_s_by_rank": [r["fit_s"] for r in runs["disk"]],
        "torn_fit_s": t_lead["fit_s"]}
    return live, disk, launches


def phase_elastic_nan(torch, steps=10):
    """53: the coordinator on one card (see the module docstring)."""
    import gc
    import tempfile

    import numpy as np

    from flexflow_tpu_torch.tools.tp_train import elastic_job

    gc.collect()
    torch.cuda.empty_cache()
    x, y = _elastic_batches()
    with tempfile.TemporaryDirectory() as tmp:
        out = elastic_job({
            "model": "encoder", "widths": dict(NAN_WIDTHS),
            "batch": TRAIN["batch"], "mixed": True,
            "optimizer": ("adam", 1e-4, "bfloat16"), "accuracy": True,
            "faults": [("nan_step", s, (), 1) for s in range(3, 7)],
            "x": x, "y": y, "steps": steps, "checkpoint_dir": tmp,
            "coordinator": {"checkpoint_every": 2}, "skip_witness": True,
            "trace": True}, "cuda")
        ckpt_bytes = sorted(os.path.getsize(os.path.join(tmp, f))
                            for f in os.listdir(tmp) if f.endswith(".npz"))
    seq = [tuple(e[:2]) for e in out["events"]
           if e[0] not in ("detect.slow_step", "plan.precompute")]
    losses = [h["loss"] for h in out["history"]]
    checks = {
        "jax_event_order": seq == NAN_EVENTS,
        "skips_identical": out["skips_identical"] == [True, True, True],
        "steps": [h["step"] for h in out["history"]]
        == [0, 1, 2, 3, 4, 5, 7, 8, 9],
        "finite": bool(np.all(np.isfinite(losses))),
    }
    if not all(checks.values()):
        raise AssertionError(f"elastic-nan: {checks}; events {seq}")
    missing = [k for k in ELASTIC_NAN_KERNELS if not out["launches"].get(k)]
    if missing:
        raise AssertionError(f"elastic-nan: kernels never launched: "
                             f"{missing}")
    spans = out["span_us"]
    return {"phase": "elastic-nan", "widths": NAN_WIDTHS,
            "dtype": "bfloat16", "optimizer": "adam (bf16 moments)",
            "checks": checks, "losses": losses,
            "rollback_restore_ms": [d / 1e3 for d in
                                    spans.get("elastic.rollback", [])],
            "checkpoint_save_ms": [d / 1e3 for d in
                                   spans.get("checkpoint.save", [])],
            "checkpoint_bytes": ckpt_bytes, "fit_s": out["fit_s"]}, \
        out["launches"]


def phase_elastic_drill(torch):
    """54: the port's drill, --scenario live-reshard on four ranks sharing
    the card; exits 0, its JSON line kept."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.elastic.drill",
         "--scenario", "live-reshard", "--devices", str(ELASTIC_RANKS),
         "--device", "cuda"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"elastic drill exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    summary = json.loads(lines[-1])
    return {"phase": "elastic-drill", "exit_code": proc.returncode,
            "wall_s": wall, "summary": summary}


# the fleet phases (55-58): the serve LM's widths, two replicas of 8
# slots sharing one model, max_len 1024, pages of 16
FLEET_SLOTS, FLEET_MAX_LEN, FLEET_PAGE = 8, 1024, 16
FLEET_PREFIX_PAGES = 128  # two slots' worth, the batcher's default
# the shared-prefix tenant mix of phases 55-56 (sched/bench.py
# make_shared_prefix_workload): 9 system prompts of 256 tokens (more
# than one replica's prefix band holds, 8, and odd, so round robin does
# not send each tenant's followers home by parity), a suffix of 16-64 and
# 16-32 new tokens a request
FLEET_MIX = dict(n=48, groups=9, prefix_len=256, suffix_min=16,
                 suffix_max=64, out_min=16, out_max=32, seed=55)
# the HealthMonitor's windows and poll of the JAX chaos drill's defaults
FLEET_SUSPECT_S, FLEET_DEAD_S, FLEET_PROBE_S = 2.0, 10.0, 0.1
FLEET_CRASH_AFTER = 12
# phase 57's prefill-heavy stream (sched/bench.py make_workload) and the
# machine it is priced on: the JAX tests' two pods of 8 over DCN, the
# prefill pool on one pod and the decode pool on the other
DISAGG_MIX = dict(n=12, prompt_min=384, prompt_max=512, out_min=16,
                  out_max=32, seed=57)
DISAGG_SPEC = "examples/machines/multipod_2x8.json"
DISAGG_LONG = 512  # the first prompt's tokens: the window's
# phase 58's prompts (one-shot prefill: each within the window of 512)
FLEET_SERVER_PROMPTS = (40, 130, 257, 500)
# K and V of 12 layers x 1024 wide in bf16: the bytes one prompt token's
# rows take in the handoff
DISAGG_BYTES_PER_TOKEN = 12 * 2 * 1024 * 2
FLEET_KERNELS = ("decode_attention", "multiquery_decode_attention",
                 "layernorm_fwd", "softmax_fwd")
# one-shot replicas (phase 58) prefill through the causal flash forward
FLEET_ONESHOT_KERNELS = ("flash_fwd", "decode_attention", "layernorm_fwd",
                         "softmax_fwd")
# one walk of the 12-layer serve LM: a layer's attention and its two
# LayerNorms, and the LM head's softmax
FLEET_PER_WALK = {
    "decode": {"decode_attention": 12, "layernorm_fwd": 24,
               "softmax_fwd": 1},
    "chunk": {"multiquery_decode_attention": 12, "layernorm_fwd": 24,
              "softmax_fwd": 1},
    "oneshot": {"flash_fwd": 12, "layernorm_fwd": 24, "softmax_fwd": 1},
}


def _fleet_lm_f32(torch):
    """The serve LM at full width and depth in f32 (phase 50's: greedy
    tokens that a slot count, a resize or a replay's recomputed rows do
    not tip at a bf16 tie)."""
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    return build_tiny_lm(FLEET_SLOTS, MESH_LM["window"],
                         vocab=MESH_LM["vocab"], hidden=MESH_LM["hidden"],
                         heads=MESH_LM["heads"], layers=12, device="cuda",
                         generator=torch.Generator().manual_seed(55))


def _single_tokens(lm, workload, **kw):
    """One ContinuousBatcher's greedy tokens for the workload, in order
    (the fleet's geometry)."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    # every request admitted at once: the reference queues, never sheds
    args = dict(max_len=FLEET_MAX_LEN, num_slots=FLEET_SLOTS,
                page_size=FLEET_PAGE, prefix_cache_pages=FLEET_PREFIX_PAGES,
                max_queue=len(workload) + 1, queue_pages_budget=1 << 30)
    args.update(kw)
    with ContinuousBatcher(lm, **args) as cb:
        reqs = [cb.submit(w["prompt"], w["max_new"]) for w in workload]
        return [[int(t) for t in r.result(timeout=900)] for r in reqs]


def _fleet_summary(run, keys=("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
                              "ttft_steady_ms_p99", "wall_s", "tokens",
                              "requests", "dropped", "hits", "misses",
                              "handoffs", "routes", "shed_retries")):
    return {k: run[k] for k in keys if k in run}


def _fleet_walk_launches(torch, lm, oneshot=False):
    """The launches of one eager decode walk and one prefill chunk (or
    one-shot prefill) of a replica of the fleet's geometry: what each
    capture and warm-up walk of its graphs launches."""
    import numpy as np

    from flexflow_tpu_torch.serving.fleet import Replica

    if oneshot:
        rep = Replica("walk", lm, start=False, max_len=FLEET_MAX_LEN,
                      num_slots=FLEET_SLOTS, page_size=FLEET_PAGE,
                      prefill_chunk_tokens=0, prefix_cache_pages=0)
    else:
        rep = Replica("walk", lm, start=False, max_len=FLEET_MAX_LEN,
                      num_slots=FLEET_SLOTS, page_size=FLEET_PAGE,
                      prefix_cache_pages=0)
    cb = rep.batcher
    out = {}
    with torch.no_grad():
        out["decode"] = _walk_launches(torch, cb._decode_walk)
        if oneshot:
            def walk():
                padded = np.zeros((1, cb.window), np.int32)
                cb.model.executor.forward_values(
                    {cb._input_name: torch.from_numpy(padded).cuda()},
                    state=cb._slot_caches[0], fill_kv_cache=True)
            out["oneshot"] = _walk_launches(torch, walk)
        else:
            out["chunk"] = _walk_launches(torch, cb._chunk_walk(0))
    del rep, cb
    return out


def _spec_per_walk(lm, draft, k):
    """What one speculative iteration launches: k draft steps on the C=1
    decode entry, then the target's verify over k + 1 rows on the C>=1
    entry, each model's LayerNorms and LM-head softmax a walk."""
    def n(m, kind):
        return sum(op.op_type.value == kind for op in m.graph.ops.values())

    return {"decode_attention": k * n(draft, "multihead_attention"),
            "multiquery_decode_attention": n(lm, "multihead_attention"),
            "layernorm_fwd": n(lm, "layernorm") + k * n(draft, "layernorm"),
            "softmax_fwd": n(lm, "softmax") + k * n(draft, "softmax")}


def _spec_iteration_launches(torch, cb, seed):
    """The launches of one eager speculative iteration of batcher cb
    (tokens drawn from seed, every slot at a position with room for its
    k proposals). It writes K/V rows of every slot: call it on an idle
    batcher whose caches are not read again."""
    import numpy as np

    rng = np.random.RandomState(seed)
    S, vocab = cb.num_slots, cb.model.final_tensor.dims[-1]
    host = np.concatenate([
        rng.randint(1, vocab, size=S),
        rng.randint(0, cb.max_len - cb.spec_tokens, size=S)]
    ).astype(np.int32)
    with torch.no_grad():
        return _walk_launches(torch, lambda: (cb._spec_in.put(host),
                                              cb._spec_walk()))


def phase_fleet(torch, lm, lm32, vocab):
    """55: two replicas of the serve LM behind the Router. The static
    shared-prefix mix under "affine" and "round_robin" (bf16), then the
    peak -> trough -> peak swing with the Autoscaler live and one replica
    drained mid-burst (f32). Returns the phase's record, its launches and
    the f32 single-batcher tokens phase 56 holds its failover to."""
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.serving.fleet.bench import (run_fleet_autoscale,
                                                        run_fleet_static)
    from flexflow_tpu_torch.serving.sched.bench import \
        make_shared_prefix_workload

    t0 = time.perf_counter()
    mix = dict(FLEET_MIX)
    workload = make_shared_prefix_workload(vocab=vocab, **mix)
    ref = _single_tokens(lm, workload)
    ref32 = _single_tokens(lm32, workload)
    common = dict(n_replicas=2, slots=FLEET_SLOTS, page_size=FLEET_PAGE,
                  max_len=FLEET_MAX_LEN,
                  prefix_cache_pages=FLEET_PREFIX_PAGES, slo_ttft_s=None,
                  deadline_s=600.0)
    reset_launch_counts()
    runs = {p: run_fleet_static(lm, workload, policy=p, **common)
            for p in ("affine", "round_robin")}
    launches = {k: n for k, n in launch_counts().items() if n}
    scale = run_fleet_autoscale(lm32, workload, min_slots=4, max_slots=16,
                                **common)
    walks = _fleet_walk_launches(torch, lm)
    failures = []
    for name, run in list(runs.items()) + [("autoscale", scale)]:
        want = ref32 if name == "autoscale" else ref
        same = sum(1 for a, b in zip(run["token_lists"], want) if a == b)
        run["identical_to_single_batcher"] = same
        if run["dropped"] or same != len(workload):
            failures.append(f"{name}: {run['dropped']} dropped, {same} of "
                            f"{len(workload)} token lists equal one "
                            f"batcher's")
        fams = run["exposition"]["replica_labeled_families"]
        if not {"ff_serving_ttft_ms", "ff_kvpool_pages_used"} <= set(fams):
            failures.append(f"{name}: replica-labelled families {fams}")
    if not scale["grows_applied"] or not scale["shrinks_applied"]:
        failures.append(f"autoscale: {scale['grows_applied']} grows, "
                        f"{scale['shrinks_applied']} shrinks applied")
    if scale["drained_replica"] is None:
        failures.append("autoscale: no replica drained")
    missing = [k for k in FLEET_KERNELS if not launches.get(k)]
    if missing:
        failures.append(f"fleet: kernels never launched: {missing}")
    wrong = {k: v for k, v in walks.items() if v != FLEET_PER_WALK[k]}
    if wrong:
        failures.append(f"fleet: launches a walk {wrong}, expected "
                        f"{FLEET_PER_WALK}")
    line = {
        "phase": "fleet", "card": _card_line(),
        "model": "serve LM, hidden 1024, 16 heads, 12 layers, vocab "
                 "30522, window 512; 2 replicas sharing its weights, 8 "
                 "slots each, max_len 1024, page 16",
        "workload": mix,
        "affine": _fleet_summary(runs["affine"]),
        "round_robin": _fleet_summary(runs["round_robin"]),
        "affine_vs_round_robin_ttft_p99": (
            runs["round_robin"]["ttft_ms_p99"]
            / max(runs["affine"]["ttft_ms_p99"], 1e-9)),
        "autoscale": dict(
            _fleet_summary(scale), model="the same LM in f32",
            grows_applied=scale["grows_applied"],
            shrinks_applied=scale["shrinks_applied"],
            drained_replica=scale["drained_replica"],
            drain=scale["drain"], phases=scale["phases"],
            resizes=[{k: r.get(k) for k in ("replica", "from", "to",
                                            "direction", "migrated_rows",
                                            "predicted_us", "wall_ms")}
                     for r in scale["resizes"]]),
        "identical_to_single_batcher": {
            n: r["identical_to_single_batcher"]
            for n, r in list(runs.items()) + [("autoscale", scale)]},
        "replica_labeled_families":
            runs["affine"]["exposition"]["replica_labeled_families"],
        "launches_per_walk": walks,
        "launches_cover": "the static runs' replicas' warm-up and "
                          "capture walks (a replay counts nothing)",
        "wall_s": time.perf_counter() - t0,
        "tolerance": "0 drops; every greedy token list equal to one "
                     "ContinuousBatcher's on the same prompts (bf16 "
                     "static runs, f32 autoscale); >= 1 grow and shrink "
                     "applied; a replica drained; the merged exposition "
                     "validates with ff_serving_ttft_ms and "
                     "ff_kvpool_pages_used under `replica`",
    }
    _emit(dict(line, launches=launches))
    if failures:
        raise AssertionError(f"fleet: {failures}")
    return line, launches, workload, ref32


def phase_chaos(torch, lm32, workload, ref32):
    """56: the chaos drill on the f32 LM: a crash FLEET_CRASH_AFTER tokens
    after arming on the loaded replica, under a live HealthMonitor and
    Autoscaler (respawn), traced with a flight recorder armed."""
    import tempfile

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.serving.fleet.bench import run_fleet_chaos

    t0 = time.perf_counter()
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="ff_chaos_") as tmp:
        run = run_fleet_chaos(
            lm32, workload, n_replicas=2, slots=FLEET_SLOTS,
            page_size=FLEET_PAGE, max_len=FLEET_MAX_LEN,
            prefix_cache_pages=FLEET_PREFIX_PAGES, deadline_s=600.0,
            crash_after_tokens=FLEET_CRASH_AFTER,
            suspect_after_s=FLEET_SUSPECT_S, dead_after_s=FLEET_DEAD_S,
            probe_interval_s=FLEET_PROBE_S, artifact_dir=tmp)
        dumps = run["artifacts"]["flight_dumps"]
        bundle = sorted(os.listdir(dumps[0])) if dumps else []
    launches = {k: n for k, n in launch_counts().items() if n}
    cont = run["trace_continuity"]
    same = sum(1 for a, b in zip(run["token_lists"], ref32) if a == b)
    failures = []
    if run["dropped"] or same != len(workload):
        failures.append(f"{run['dropped']} dropped, {same} of "
                        f"{len(workload)} token lists equal the "
                        f"undisturbed batcher's")
    if not run["failed_over_requests"] or cont["unstitched"] \
            or cont["stitched"] != cont["failed_over"]:
        failures.append(f"failover and trace continuity {cont}")
    if not dumps or "recorder.json" not in bundle:
        failures.append(f"flight recorder bundle {dumps} {bundle}")
    if run["detect_s"] is None or run["detect_s"] > FLEET_DEAD_S:
        failures.append(f"time to DEAD {run['detect_s']}")
    missing = [k for k in FLEET_KERNELS if not launches.get(k)]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    line = {
        "phase": "chaos", "card": _card_line(),
        "model": "serve LM, 12 layers, f32; 2 replicas of 8 slots",
        "victim": run["victim"], "faults_fired": [
            {k: f[k] for k in ("kind", "replica", "token", "at_token")}
            for f in run["faults_fired"]],
        "time_to_dead_s": run["detect_s"], "recover_s": run["recover_s"],
        "failed_over_requests": run["failed_over_requests"],
        "failovers": run["failovers"],
        "identical_to_undisturbed": same,
        "trace_continuity": {k: cont[k] for k in
                             ("failed_over", "mid_decode", "stitched",
                              "unstitched")},
        "flight_dumps": len(dumps), "bundle_files": bundle,
        "health_after": run["health_after"],
        "monitor_states": run["monitor_states"],
        **_fleet_summary(run),
        "windows_s": {"suspect": FLEET_SUSPECT_S, "dead": FLEET_DEAD_S,
                      "probe": FLEET_PROBE_S},
        "wall_s_phase": time.perf_counter() - t0,
        "tolerance": "0 drops; every token list equal to one undisturbed "
                     "batcher's; every failed-over request's spans under "
                     "its one trace id; a flight-recorder bundle; DEAD "
                     "within the dead window",
    }
    _emit(dict(line, launches=launches))
    if failures:
        raise AssertionError(f"chaos: {failures}")
    return line, launches


def phase_disagg(torch, lm, vocab):
    """57: the same prefill-heavy stream through ["unified", "unified"]
    and ["prefill", "decode"] (bf16), the handoffs priced on the
    two-pod machine spec."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.resharding.plan import TRANSFER_TIER_CHUNK_BYTES
    from flexflow_tpu_torch.search.machine_model import (
        HierarchicalMachineModel, load_machine_spec)
    from flexflow_tpu_torch.serving.fleet.bench import run_disagg_fleet
    from flexflow_tpu_torch.serving.sched.bench import make_workload

    t0 = time.perf_counter()
    mix = dict(DISAGG_MIX)
    workload = make_workload(vocab=vocab, **mix)
    # one prompt of the window's 512 tokens (its rows: 25,165,824 bytes)
    workload[0]["prompt"] = np.random.RandomState(570).randint(
        1, vocab, size=DISAGG_LONG).astype(np.int32)
    machine = HierarchicalMachineModel.from_json(load_machine_spec(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     DISAGG_SPEC)))
    common = dict(slots=FLEET_SLOTS, page_size=FLEET_PAGE,
                  max_len=FLEET_MAX_LEN, deadline_s=600.0,
                  concurrency=FLEET_SLOTS, machine=machine,
                  device_ids=tuple(range(machine.num_chips)))
    uni = run_disagg_fleet(lm, workload, roles=["unified", "unified"],
                           **common)
    reset_launch_counts()
    dis = run_disagg_fleet(lm, workload, roles=["prefill", "decode"],
                           **common)
    launches = {k: n for k, n in launch_counts().items() if n}
    log = dis["handoff_log"]
    same = sum(1 for a, b in zip(dis["token_lists"], uni["token_lists"])
               if a == b)
    failures = []
    if uni["dropped"] or dis["dropped"] or same != len(workload):
        failures.append(f"{uni['dropped']} / {dis['dropped']} dropped, "
                        f"{same} of {len(workload)} token lists equal")
    if not log:
        failures.append("no handoff committed")
    for h in log:
        if not h["predicted_us"] > 0 or \
                h["bytes"] / h["chunks"] > TRANSFER_TIER_CHUNK_BYTES or \
                h["bytes"] != DISAGG_BYTES_PER_TOKEN * h["tokens"]:
            failures.append(f"handoff {h}")
    missing = [k for k in FLEET_KERNELS if not launches.get(k)]
    if missing:
        failures.append(f"kernels never launched: {missing}")

    def pct(key, q):
        return float(np.percentile([h[key] for h in log], q)) if log \
            else None

    line = {
        "phase": "disagg", "card": _card_line(),
        "model": "serve LM, bf16; 2 replicas of 8 slots sharing it",
        "workload": dict(mix, first_prompt=DISAGG_LONG),
        "unified": dict(_fleet_summary(uni), itl_ms_p50=uni["itl_ms_p50"],
                        itl_ms_p99=uni["itl_ms_p99"]),
        "disagg": dict(_fleet_summary(dis), itl_ms_p50=dis["itl_ms_p50"],
                       itl_ms_p99=dis["itl_ms_p99"],
                       handoff=dis["handoff"]),
        "identical_tokens": same,
        "handoffs": len(log),
        "bytes_per_token": DISAGG_BYTES_PER_TOKEN,
        "handoff_longest": next((h for h in log
                                 if h["tokens"] == DISAGG_LONG), None),
        "handoff_ms_p50": {k: pct(k, 50) for k in ("export_ms",
                                                   "import_ms", "wall_ms")},
        "predicted_us_p50": pct("predicted_us", 50),
        "handoff_log": log,
        "priced_on": DISAGG_SPEC + " (two 8-chip pods over DCN, prefill "
                     "and decode pools on different pods); the walls are "
                     "a device -> host -> device copy on one card, not a "
                     "link",
        "wall_s": time.perf_counter() - t0,
        "tolerance": "0 drops; the disaggregated fleet's tokens equal the "
                     "unified fleet's; every committed handoff priced, "
                     "<= 64 MB a chunk, 49,152 B a prompt token",
    }
    _emit(dict(line, launches=launches))
    if failures:
        raise AssertionError(f"disagg: {failures}")
    return line, launches


def phase_fleet_server(torch, lm):
    """58: a fleet of two one-shot replicas registered on the HTTP server:
    /generate plain and NDJSON through it, /metrics merged under a
    `replica` label, /healthz aggregated and degraded once a replica is
    declared dead."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.obs.registry import validate_exposition
    from flexflow_tpu_torch.serving import InferenceServer
    from flexflow_tpu_torch.serving.fleet import Replica, ReplicaLost, Router

    t0 = time.perf_counter()
    rng = np.random.RandomState(58)
    vocab = lm.final_tensor.dims[-1]
    prompts = [rng.randint(1, vocab, size=int(n)).astype(np.int32)
               for n in FLEET_SERVER_PROMPTS]
    new = 16
    oneshot = dict(max_len=FLEET_MAX_LEN, num_slots=FLEET_SLOTS,
                   page_size=FLEET_PAGE, prefill_chunk_tokens=0,
                   prefix_cache_pages=0)
    want = _single_tokens(lm, [{"prompt": p, "max_new": new}
                               for p in prompts], **oneshot)
    reset_launch_counts()
    router = Router()
    for i in range(2):
        router.add_replica(f"r{i}", Replica(f"r{i}", lm, **oneshot))
    server = InferenceServer()
    server.register_fleet("lm", router)
    httpd = server.serve_http(port=0)
    failures = []
    try:
        port = httpd.server_address[1]
        path = "/v2/models/lm/generate"
        t_req = time.perf_counter()
        plain = json.loads(_http(port, path, {
            "prompt": [p.tolist() for p in prompts],
            "max_new_tokens": new})[2])["tokens"]
        plain_s = time.perf_counter() - t_req
        _, headers, body = _http(port, path, {"prompt": prompts[2].tolist(),
                                              "max_new_tokens": new,
                                              "stream": True})
        lines = [json.loads(ln) for ln in body.splitlines()]
        streamed = [ln["token"] for ln in lines[:-1]]
        if headers.get("Content-Type") != "application/x-ndjson":
            failures.append(f"stream content type {headers}")
        metrics = _http(port, "/metrics")[2].decode()
        fams = validate_exposition(metrics)
        labeled = sorted(n for n, f in fams.items()
                         if any("replica" in lb for _, lb, _ in f["samples"]))
        health_ok = json.loads(_http(port, "/healthz")[2])
        router.fail_over("r1", reason="scheduler_crashed",
                         error=ReplicaLost("r1 declared dead"))
        health_dead = json.loads(_http(port, "/healthz")[2])
        after = json.loads(_http(port, path, {
            "prompt": [prompts[0].tolist()],
            "max_new_tokens": new})[2])["tokens"]
    finally:
        httpd.shutdown()
        server.shutdown()
    launches = {k: n for k, n in launch_counts().items() if n}
    if plain != want or streamed != want[2] or lines[-1]["tokens"] != want[2] \
            or after != [want[0]]:
        failures.append(f"tokens: plain {plain == want}, stream "
                        f"{streamed == want[2]}, after the loss "
                        f"{after == [want[0]]}")
    if not {"ff_serving_ttft_ms", "ff_kvpool_pages_used"} <= set(labeled) \
            or "ff_fleet_requests_total" not in fams:
        failures.append(f"/metrics families under `replica`: {labeled}")
    if health_ok["status"] != "ok" or health_ok["fleets"]["lm"]["ready"] != 2:
        failures.append(f"/healthz before the loss: {health_ok}")
    if health_dead["status"] != "degraded" or \
            health_dead["fleets"]["lm"]["lost_replicas"] != {
                "r1": "scheduler_crashed"}:
        failures.append(f"/healthz after the loss: {health_dead}")
    missing = [k for k in FLEET_ONESHOT_KERNELS if not launches.get(k)]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    walks = _fleet_walk_launches(torch, lm, oneshot=True)
    if walks["oneshot"] != FLEET_PER_WALK["oneshot"] or \
            walks["decode"] != FLEET_PER_WALK["decode"]:
        failures.append(f"launches a walk {walks}")
    line = {
        "phase": "fleet-server", "card": _card_line(),
        "model": "serve LM, bf16; 2 one-shot replicas of 8 slots",
        "prompts": [len(p) for p in prompts], "new_tokens": new,
        "plain_request_s": plain_s, "ndjson_lines": len(lines),
        "replica_labeled_families": labeled,
        "metrics_lines": len(metrics.splitlines()),
        "healthz": {"before": health_ok["status"],
                    "after_loss": health_dead["status"]},
        "launches_per_walk": walks,
        "wall_s": time.perf_counter() - t0,
        "tolerance": "plain, NDJSON and after-the-loss tokens equal one "
                     "one-shot batcher's; /metrics validates with the "
                     "replica label; /healthz ok, then degraded with r1 "
                     "lost",
    }
    _emit(dict(line, launches=launches))
    if failures:
        raise AssertionError(f"fleet-server: {failures}")
    return line, launches


# 59-62: the graph importers (ONNX, torch.fx, the C model spec) and the
# model repository, at the repo's own widths. Weights random from seeds
IMPORT_SEED = 59
INIT_STD = 0.02
# the zoo's mnist_mlp (tests/test_mnist_mlp.py, models/cnn.py)
MNIST_BATCH, MNIST_WIDTHS = 64, (784, 512, 512, 10)
# 59(b): two attention layers at the flagship's widths
ONNX_ATTN = dict(batch=8, seq=512, hidden=1024, heads=16, ffn=4096,
                 layers=2)
# f32 against numpy's evaluation of the same graph (JAX's test tolerance,
# atol and rtol); bf16 activations: max |err| <= IMPORT_BF16_REL * max|ref|
IMPORT_F32_TOL = 1e-4
IMPORT_BF16_REL = 2e-2
# 60: the encoder traced from torch, the module's own forward the
# reference (atol, rtol in f32; absolute on its probabilities in bf16)
FX_ENCODER = dict(vocab=30522, hidden=1024, heads=16, layers=12,
                  ffn=4096, seq=512, batch=8)
FX_F32_TOL = 1e-3
FX_BF16_TOL = 5e-2
FX_STEPS, FX_LR = 3, 1e-3
# launches of one bf16 predict walk and one fit step of the encoder
FX_PER_WALK = {"flash_fwd": 12, "flash_fwd/tc": 12, "layernorm_fwd": 24,
               "softmax_fwd": 1}
FX_PER_STEP = {"flash_fwd": 12, "flash_fwd/tc": 12, "flash_bwd": 12,
               "flash_bwd/tc": 12, "layernorm_fwd": 24, "layernorm_bwd": 24,
               "softmax_fwd": 1, "softmax_bwd": 1, "optimizer_sgd": 1}
CSPEC_STEPS, CSPEC_LR, CSPEC_LOSS_REL = 3, 0.05, 1e-5
# 62: the serve LM's fleet entry (its speculative draft: 2 layers at the
# same widths) and disaggregated entry (one-shot prefill: the causal
# flash forward), and the prompts both serve over /generate
REPO_DRAFT_LAYERS, REPO_SPEC_TOKENS = 2, 3
REPO_PROMPTS, REPO_NEW = (40, 130, 257, 500), 16
# the frontends' walks the kernel table's column reads
FRONTEND_WALKS = ("fx-predict-bf16", "fx-fit-step", "onnx-b-predict",
                  "cspec-predict", "repository-fleet-spec-iter")


def _launches_wrong(phase, launches, want=None, present=()):
    """What is wrong with a frontend phase's launches: a kernel of `want`
    launched another count than want[k], or one of `present` never."""
    want = want or {}
    wrong = {k: (launches.get(k, 0), n) for k, n in want.items()
             if launches.get(k, 0) != n}
    wrong.update({k: (0, ">= 1") for k in present if not launches.get(k)})
    return [f"{phase}: launches (got, want) {wrong}"] if wrong else []


def _launches_since(before):
    """The launches since `before` (a launch_counts() reading), routes
    included: a walk inside a phase whose own count runs from its
    start."""
    from flexflow_tpu_torch.kernels import launch_counts

    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n > before.get(k, 0)}


def _gelu_tanh(np, x):
    """The importer's Gelu: fm.gelu, JAX's tanh form."""
    return 0.5 * x * (1.0 + np.tanh(0.7978845608028654
                                    * (x + 0.044715 * x ** 3)))


def _softmax_np(np, x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _mnist_onnx(np, wire):
    """59(a): mnist_mlp as ONNX (Gemm, Relu, Softmax), its initializers
    and the numpy evaluation of the graph."""
    rng = np.random.RandomState(IMPORT_SEED)
    w = MNIST_WIDTHS
    inits, nodes, prev = {}, [], "x"
    for i in range(3):
        inits[f"w{i}"] = (rng.randn(w[i], w[i + 1]) * INIT_STD).astype(
            np.float32)
        inits[f"b{i}"] = (rng.randn(w[i + 1]) * INIT_STD).astype(np.float32)
        nodes.append(wire.make_node("Gemm", [prev, f"w{i}", f"b{i}"],
                                    [f"g{i}"], name=f"mlp{i + 1}"))
        prev = f"g{i}"
        if i < 2:
            nodes.append(wire.make_node("Relu", [prev], [f"r{i}"],
                                        name=f"relu{i + 1}"))
            prev = f"r{i}"
    nodes.append(wire.make_node("Softmax", [prev], ["y"], name="softmax",
                                axis=-1))
    proto = wire.make_model(nodes, {"x": (MNIST_BATCH, w[0])},
                            {"y": (MNIST_BATCH, w[-1])}, inits,
                            name="mnist_mlp")

    def ref(x):
        h = x
        for i in range(3):
            h = h @ inits[f"w{i}"] + inits[f"b{i}"]
            if i < 2:
                h = np.maximum(h, 0)
        return _softmax_np(np, h)

    return proto, inits, ref


def _attn_onnx(np, wire):
    """59(b): ONNX_ATTN's layers, each scaled dot-product attention over
    16 heads and a Gelu FFN with residual Adds; its initializers and the
    numpy evaluation of the graph."""
    c = ONNX_ATTN
    b, l, e, h, f = c["batch"], c["seq"], c["hidden"], c["heads"], c["ffn"]
    hd = e // h
    rng = np.random.RandomState(IMPORT_SEED + 1)
    inits = {"heads_shape": np.array([b, l, h, hd], np.int64),
             "merge_shape": np.array([0, 0, -1], np.int64),
             "scale": np.array(np.sqrt(hd), np.float32)}
    nodes, x = [], "x"
    for i in range(c["layers"]):
        for name, shape in (("wq", (e, e)), ("wk", (e, e)), ("wv", (e, e)),
                            ("wo", (e, e)), ("w1", (e, f)), ("w2", (f, e))):
            inits[f"l{i}_{name}"] = (rng.randn(*shape) * INIT_STD).astype(
                np.float32)

        def n(op, ins, out, name, **kw):
            nodes.append(wire.make_node(op, ins, [out], name=f"l{i}_{name}",
                                        **kw))
            return out

        heads = {}
        for p, perm in (("q", [0, 2, 1, 3]), ("k", [0, 2, 3, 1]),
                        ("v", [0, 2, 1, 3])):
            t = n("MatMul", [x, f"l{i}_w{p}"], f"l{i}_{p}", f"proj_{p}")
            t = n("Reshape", [t, "heads_shape"], f"l{i}_{p}4", f"split_{p}")
            heads[p] = n("Transpose", [t], f"l{i}_{p}h", f"{p}T", perm=perm)
        t = n("MatMul", [heads["q"], heads["k"]], f"l{i}_s", "scores")
        t = n("Div", [t, "scale"], f"l{i}_ss", "scaled")
        t = n("Softmax", [t], f"l{i}_p", "probs", axis=-1)
        t = n("MatMul", [t, heads["v"]], f"l{i}_ctx", "context")
        t = n("Transpose", [t], f"l{i}_ctxT", "ctxT", perm=[0, 2, 1, 3])
        t = n("Reshape", [t, "merge_shape"], f"l{i}_m", "merge")
        t = n("MatMul", [t, f"l{i}_wo"], f"l{i}_o", "out_proj")
        r = n("Add", [x, t], f"l{i}_r", "residual1")
        t = n("MatMul", [r, f"l{i}_w1"], f"l{i}_f1", "ffn1")
        t = n("Gelu", [t], f"l{i}_g", "gelu")
        t = n("MatMul", [t, f"l{i}_w2"], f"l{i}_f2", "ffn2")
        x = n("Add", [r, t], "y" if i == c["layers"] - 1 else f"l{i}_y",
              "residual2")
    proto = wire.make_model(nodes, {"x": (b, l, e)}, {"y": (b, l, e)}, inits,
                            name="attention")

    def ref(xv):
        for i in range(c["layers"]):
            w = {k: inits[f"l{i}_{k}"] for k in ("wq", "wk", "wv", "wo",
                                                 "w1", "w2")}
            q, k, v = ((xv @ w[f"w{p}"]).reshape(b, l, h, hd)
                       .transpose(0, 2, 1, 3) for p in "qkv")
            p = _softmax_np(np, q @ k.transpose(0, 1, 3, 2)
                            / np.float32(np.sqrt(hd)))
            ctx = (p @ v).transpose(0, 2, 1, 3).reshape(b, l, e)
            r = xv + ctx @ w["wo"]
            xv = r + _gelu_tanh(np, r @ w["w1"]) @ w["w2"]
        return xv

    return proto, inits, ref


def _onnx_import(torch, path, dims, mixed, dtype=None):
    """An FFModel on the card from the ONNX file, compiled for inference,
    its initializers transferred: (model, ONNXModel, weights copied)."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.onnx import ONNXModel

    model = ff.FFModel(ff.FFConfig(batch_size=dims[0], device="cuda",
                                   allow_mixed_precision=mixed))
    t = model.create_tensor(list(dims), dtype or ff.DataType.DT_FLOAT)
    om = ONNXModel(path)
    model.final_tensor = om.apply(model, [t])[0]
    model.compile(optimizer=ff.SGDOptimizer(model, lr=0.0),
                  loss_type=ff.LossType.LOSS_IDENTITY)
    return model, om, om.transfer_weights(model)


def _predict_ms(model, x, reps=5):
    """Host wall of predict (which returns host arrays, so the device is
    done) over reps calls after one: the median, in ms."""
    import numpy as np

    model.predict(x)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.predict(x)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _transferred_equal(np, model, om):
    """Every stashed initializer equals the model's weight, to the bit."""
    params = model.params
    return all(np.array_equal(params[op][k].float().cpu().numpy(),
                              np.asarray(v, np.float32))
               for op, slot in om._pending_weights.items()
               for k, v in slot.items())


def phase_onnx(torch, tmp):
    """59: the two ONNX graphs through ONNXModel, f32 and bf16. Returns
    the phase's record, each graph's file path and inputs, and the
    launches of a bf16 predict walk of (b)."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts
    from flexflow_tpu_torch.onnx import wire

    t0 = time.perf_counter()
    rng = np.random.RandomState(IMPORT_SEED)
    graphs = {"mnist_mlp": _mnist_onnx(np, wire),
              "attention": _attn_onnx(np, wire)}
    inputs = {"mnist_mlp": rng.randn(MNIST_BATCH, MNIST_WIDTHS[0]).astype(
                  np.float32),
              "attention": rng.randn(ONNX_ATTN["batch"], ONNX_ATTN["seq"],
                                     ONNX_ATTN["hidden"]).astype(np.float32)}
    line = {"phase": "onnx", "card": _card_line(), "graphs": {}}
    paths, failures, walk = {}, [], {}
    for name, (proto, inits, ref_fn) in graphs.items():
        paths[name] = os.path.join(tmp, f"{name}.onnx")
        wire.save(proto, paths[name])
        x = inputs[name]
        t_ref = time.perf_counter()
        ref = ref_fn(x)
        rec = {"bytes": len(proto), "nodes": len(wire.load(proto).graph.node),
               "initializers": len(inits),
               "numpy_reference_s": time.perf_counter() - t_ref}
        for prec, mixed in (("f32", False), ("bf16", True)):
            model, om, n = _onnx_import(torch, paths[name], x.shape, mixed)
            expected = sum(len(v) for v in om._pending_weights.values())
            same = _transferred_equal(np, model, om)
            if prec == "bf16" and name == "attention":
                before = launch_counts()
                out = model.predict(x)
                walk = _launches_since(before)
            else:
                out = model.predict(x)
            err = float(np.abs(out - ref).max())
            r = {"transferred": n, "stashed": expected,
                 "transferred_equal": same, "max_abs_err": err,
                 "max_abs_ref": float(np.abs(ref).max()),
                 "finite": bool(np.isfinite(out).all()),
                 "predict_ms": _predict_ms(model, x)}
            if prec == "f32":
                ok = np.allclose(out, ref, atol=IMPORT_F32_TOL,
                                 rtol=IMPORT_F32_TOL)
            else:
                ok = err <= IMPORT_BF16_REL * r["max_abs_ref"]
            r["samples_per_s"] = x.shape[0] * 1e3 / r["predict_ms"]
            rec[prec] = r
            if not (ok and r["finite"] and same and n == expected > 0
                    and out.shape == ref.shape):
                failures.append(f"{name} {prec}: {r}")
            del model, om
        line["graphs"][name] = rec
    failures += _launches_wrong("(b) bf16 predict", walk,
                                present=("softmax_fwd",))
    line.update(onnx_b_predict_launches=walk,
                wall_s=time.perf_counter() - t0,
                tolerance=f"f32: numpy's evaluation of the graph within "
                          f"atol {IMPORT_F32_TOL}, rtol {IMPORT_F32_TOL}; "
                          f"bf16: max |err| <= {IMPORT_BF16_REL} max |ref|;"
                          f" every initializer transferred, equal to the "
                          f"bit")
    _emit(line)
    if failures:
        raise AssertionError(f"onnx: {failures}")
    return line, paths, inputs, walk


def _fx_encoder(torch):
    """60's module: a plain nn.Module encoder at FX_ENCODER's widths,
    weights from torch's default initializers under a fixed seed."""
    import torch.nn as nn
    import torch.nn.functional as F

    c = FX_ENCODER

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            e, n = c["hidden"], c["layers"]
            self.emb = nn.Embedding(c["vocab"], e)
            self.pos = nn.Parameter(torch.randn(c["seq"], e) * INIT_STD)
            self.attn = nn.ModuleList(nn.MultiheadAttention(
                e, c["heads"], batch_first=True) for _ in range(n))
            self.ln1 = nn.ModuleList(nn.LayerNorm(e) for _ in range(n))
            self.ff1 = nn.ModuleList(nn.Linear(e, c["ffn"])
                                     for _ in range(n))
            self.ff2 = nn.ModuleList(nn.Linear(c["ffn"], e)
                                     for _ in range(n))
            self.ln2 = nn.ModuleList(nn.LayerNorm(e) for _ in range(n))
            self.head = nn.Linear(e, 2)

        def forward(self, ids):
            h = self.emb(ids) + self.pos
            for attn, ln1, ff1, ff2, ln2 in zip(self.attn, self.ln1,
                                                self.ff1, self.ff2,
                                                self.ln2):
                a, _ = attn(h, h, h)
                h = ln1(h + a)
                h = ln2(h + ff2(F.gelu(ff1(h))))
            return torch.softmax(self.head(h), dim=-1)

    torch.manual_seed(IMPORT_SEED + 1)
    return Encoder().eval()


def phase_fx(torch, tmp):
    """60: the encoder through PyTorchModel (see the module docstring).
    Returns the phase's record and the launches of a bf16 predict walk
    and of a fit step."""
    import gc

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.kernels import launch_counts
    from flexflow_tpu_torch.torch import PyTorchModel, fx

    t0 = time.perf_counter()
    c = FX_ENCODER
    rng = np.random.RandomState(IMPORT_SEED + 2)
    ids = rng.randint(0, c["vocab"], size=(c["batch"], c["seq"])).astype(
        np.int32)
    y = rng.randint(0, 2, size=(c["batch"], c["seq"], 1)).astype(np.int32)
    module = _fx_encoder(torch).cuda()
    n_params = sum(p.numel() for p in module.parameters())
    with torch.no_grad():
        ref = module(torch.from_numpy(ids).long().cuda()).float().cpu() \
            .numpy()
    torch.cuda.synchronize()
    models, failures, line = {}, [], {"phase": "fx", "card": _card_line(),
                                      "params": n_params}
    for prec, mixed in (("f32", False), ("bf16", True)):
        t_b = time.perf_counter()
        model = ff.FFModel(ff.FFConfig(batch_size=c["batch"], device="cuda",
                                       allow_mixed_precision=mixed))
        t = model.create_tensor([c["batch"], c["seq"]], ff.DataType.DT_INT32)
        pt = PyTorchModel(module)
        model.final_tensor = pt.apply(model, [t])[0]
        model.compile(optimizer=ff.SGDOptimizer(model, lr=FX_LR),
                      loss_type=ff.LossType.
                      LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
        n = pt.transfer_weights(model)
        held = sum(len(ws) for ws in model.params.values())
        build_s = time.perf_counter() - t_b
        if prec == "bf16":
            before = launch_counts()
            out = model.predict(ids)
            walk = _launches_since(before)
        else:
            out = model.predict(ids)
        err = float(np.abs(out - ref).max())
        r = {"transferred": n, "weights": held, "max_abs_err": err,
             "finite": bool(np.isfinite(out).all()),
             "build_compile_transfer_s": build_s,
             "predict_ms": _predict_ms(model, ids)}
        r["samples_per_s"] = c["batch"] * 1e3 / r["predict_ms"]
        ok = (np.allclose(out, ref, atol=FX_F32_TOL, rtol=FX_F32_TOL)
              if prec == "f32" else err <= FX_BF16_TOL)
        if not (ok and r["finite"] and n == held > 0):
            failures.append(f"{prec}: {r}")
        line[prec] = r
        models[prec] = (model, pt)
    # the .ff file reloads into the same ops
    path = os.path.join(tmp, "encoder.ff")
    fx.torch_to_flexflow(module, path)
    # the user's module is done with: free it before the fit
    del module
    gc.collect()
    torch.cuda.empty_cache()
    again = ff.FFModel(ff.FFConfig(batch_size=c["batch"], device="cuda"))
    PyTorchModel(path).apply(again, [again.create_tensor(
        [c["batch"], c["seq"]], ff.DataType.DT_INT32)])

    def ops(m):
        # by name: compile orders the ops topologically
        return sorted((op.name, op.op_type.value,
                       [tuple(o.dims) for o in op.outputs]) for op in m.ops)

    bf16 = models["bf16"][0]
    same_ops = ops(again) == ops(bf16)
    if not same_ops:
        failures.append("the .ff file reloads into other ops")
    del again, models["f32"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = launch_counts()
    t_fit = time.perf_counter()
    bf16.fit(ids, y, batch_size=c["batch"], epochs=FX_STEPS)
    fit_s = time.perf_counter() - t_fit
    launches = _launches_since(before)
    records = bf16.step_stats.records()
    losses = [r["loss"] for r in records]
    step = {k: v / FX_STEPS for k, v in launches.items() if v}
    failures += _launches_wrong("a bf16 predict walk", walk, FX_PER_WALK)
    failures += _launches_wrong("a fit step", step, FX_PER_STEP,
                                present=("reduce",))
    if len(losses) != FX_STEPS or not all(np.isfinite(losses)):
        failures.append(f"fit losses {losses}")
    line.update(ff_file_bytes=os.path.getsize(path),
                ff_file_same_ops=same_ops, fit_losses=losses,
                fit_step_ms=[r["step_ms"] for r in records],
                fit_s=fit_s, predict_launches=walk,
                fit_launches_per_step=step,
                wall_s=time.perf_counter() - t0,
                tolerance=f"f32 within atol {FX_F32_TOL}, rtol {FX_F32_TOL}"
                          f" of the module's forward (f32 on the card); "
                          f"bf16 max |err| <= {FX_BF16_TOL}; every weight "
                          f"transferred; losses finite")
    _emit(line)
    if failures:
        raise AssertionError(f"fx: {failures}")
    del models, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return line, {k: v for k, v in walk.items() if "/" not in k}, \
        {k: v for k, v in step.items() if "/" not in k}


def _mnist_spec():
    """61's flexflow_tpu_c_model spec of mnist_mlp, op names as
    models/cnn.py build_mnist_mlp gives them."""
    w = MNIST_WIDTHS
    ops = [{"type": "input", "name": "input_0",
            "dims": [MNIST_BATCH, w[0]], "dtype": "float32", "inputs": [],
            "outputs": [1]}]
    for i in range(3):
        ops.append({"type": "dense", "name": f"mlp{i + 1}", "inputs": [i + 1],
                    "outputs": [i + 2],
                    "params": {"out_dim": w[i + 1],
                               "activation": "relu" if i < 2 else ""}})
    ops.append({"type": "softmax", "name": "softmax_0", "inputs": [4],
                "outputs": [5], "params": {}})
    return {"format": "flexflow_tpu_c_model",
            "config": {"batch_size": MNIST_BATCH}, "ops": ops}


def phase_cspec(torch, tmp):
    """61: the spec through model_from_spec against build_mnist_mlp (see
    the module docstring). Returns the phase's record, the spec, the
    trained model's checkpoint path and inputs, and a predict walk's
    launches."""
    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.kernels import launch_counts
    from flexflow_tpu_torch.models import build_mnist_mlp
    from flexflow_tpu_torch.native.c_model import model_from_spec
    from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    spec = _mnist_spec()
    rng = np.random.RandomState(IMPORT_SEED + 3)
    x = rng.randn(MNIST_BATCH, MNIST_WIDTHS[0]).astype(np.float32)
    y = rng.randint(0, MNIST_WIDTHS[-1], size=(MNIST_BATCH, 1)).astype(
        np.int32)

    def config():
        return ff.FFConfig(batch_size=MNIST_BATCH, device="cuda",
                           allow_mixed_precision=False)

    cm = model_from_spec(json.dumps(spec), config=config())
    zm = ff.FFModel(config())
    build_mnist_mlp(zm, zm.create_tensor([MNIST_BATCH, MNIST_WIDTHS[0]]))
    for m in (cm, zm):
        m.compile(optimizer=ff.SGDOptimizer(m, lr=CSPEC_LR),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[])
    zm.load_params(cm.params)
    before = launch_counts()
    p_spec = cm.predict(x)
    walk = {k: n for k, n in _launches_since(before).items()
            if "/" not in k}
    p_zoo = zm.predict(x)
    predict_err = float(np.abs(p_spec - p_zoo).max())
    losses = {}
    for name, m in (("spec", cm), ("zoo", zm)):
        m.fit(x, y, batch_size=MNIST_BATCH, epochs=CSPEC_STEPS)
        losses[name] = [r["loss"] for r in m.step_stats.records()]
    ckpt = save_checkpoint(os.path.join(tmp, "mnist_trained"), cm)
    trained = cm.predict(x)
    failures = []
    if predict_err > 1e-5 or not np.isfinite(p_spec).all():
        failures.append(f"predict differs by {predict_err}")
    if len(losses["spec"]) != CSPEC_STEPS or not all(
            abs(a - b) <= CSPEC_LOSS_REL * abs(b)
            for a, b in zip(losses["spec"], losses["zoo"])):
        failures.append(f"losses {losses}")
    failures += _launches_wrong("predict", walk, present=("softmax_fwd",))
    line = {"phase": "cspec", "card": _card_line(),
            "ops": [op["name"] for op in spec["ops"]],
            "predict_max_abs_err": predict_err, "losses": losses,
            "predict_ms": _predict_ms(cm, x), "predict_launches": walk,
            "checkpoint_bytes": os.path.getsize(ckpt),
            "wall_s": time.perf_counter() - t0,
            "tolerance": f"predict within 1e-5 of build_mnist_mlp's; "
                         f"{CSPEC_STEPS} SGD losses within "
                         f"{CSPEC_LOSS_REL} relative (f32)"}
    _emit(line)
    if failures:
        raise AssertionError(f"cspec: {failures}")
    return line, spec, ckpt, x, trained, walk


def _write_entry(root, name, config, files=()):
    d = os.path.join(root, name)
    os.makedirs(d)
    for fname, src in files:
        with open(src, "rb") as f_in, open(os.path.join(d, fname),
                                            "wb") as f_out:
            f_out.write(f_in.read())
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    return d


def phase_repository(torch, lm, tmp, onnx_paths, onnx_inputs, spec, ckpt,
                     cspec_x, cspec_trained):
    """62: the model repository on the HTTP server (see the module
    docstring). Returns the phase's record and its launches."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.obs.registry import validate_exposition
    from flexflow_tpu_torch.resharding.plan import TRANSFER_TIER_CHUNK_BYTES
    from flexflow_tpu_torch.serving import InferenceServer, ModelRepository
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    t0 = time.perf_counter()
    root = os.path.join(tmp, "repository")
    os.makedirs(root)
    _write_entry(root, "onnx_mlp", {
        "format": "onnx", "file": "model.onnx",
        "inputs": [{"dims": [MNIST_BATCH, MNIST_WIDTHS[0]],
                    "dtype": "float32"}]},
        [("model.onnx", onnx_paths["mnist_mlp"])])
    c = ONNX_ATTN
    # the graph's Reshapes carry its batch: one bucket, the built batch
    _write_entry(root, "onnx_attention", {
        "format": "onnx", "file": "model.onnx", "mixed_precision": False,
        "batch_buckets": [c["batch"]],
        "inputs": [{"dims": [c["batch"], c["seq"], c["hidden"]],
                    "dtype": "float32"}]},
        [("model.onnx", onnx_paths["attention"])])
    spec_path = os.path.join(tmp, "mnist_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    _write_entry(root, "cspec", {"format": "ff_cspec",
                                 "file": "model_spec.json",
                                 "checkpoint": "weights.npz"},
                 [("model_spec.json", spec_path), ("weights.npz", ckpt)])
    _write_entry(root, "broken", {"format": "onnx", "file": "missing.onnx",
                                  "inputs": [{"dims": [1, 4]}]})
    disagg_dir = _write_entry(
        root + "_lm", "disagg", {}, [("machine.json", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), DISAGG_SPEC))])
    vocab = lm.final_tensor.dims[-1]
    window = lm.input_ops[0].outputs[0].dims[1]
    geometry = dict(max_len=FLEET_MAX_LEN, num_slots=FLEET_SLOTS,
                    page_size=FLEET_PAGE)
    draft = build_tiny_lm(FLEET_SLOTS, window, vocab=vocab,
                          hidden=MESH_LM["hidden"], heads=MESH_LM["heads"],
                          layers=REPO_DRAFT_LAYERS, mixed_precision=True,
                          device="cuda",
                          generator=torch.Generator().manual_seed(62))
    rng = np.random.RandomState(62)
    prompts = [rng.randint(1, vocab, size=int(n)).astype(np.int32)
               for n in REPO_PROMPTS]
    oneshot = dict(prefill_chunk_tokens=0, prefix_cache_pages=0)
    want = {"fleet": _single_tokens(
                lm, [{"prompt": p, "max_new": REPO_NEW} for p in prompts],
                draft_model=draft, spec_tokens=REPO_SPEC_TOKENS),
            "disagg": _single_tokens(
                lm, [{"prompt": p, "max_new": REPO_NEW} for p in prompts],
                **oneshot)}
    plain = _single_tokens(lm, [{"prompt": p, "max_new": REPO_NEW}
                                for p in prompts])
    torch.cuda.synchronize()
    reset_launch_counts()
    server = InferenceServer()
    repo = ModelRepository(root)
    failures = []
    t_load = time.perf_counter()
    loaded = repo.load(server)
    load_s = time.perf_counter() - t_load
    ModelRepository._register_fleet(
        server, "lm_fleet", lm,
        dict(geometry, mode="fleet", replicas=2,
             speculative={"draft": "lm_draft", "tokens": REPO_SPEC_TOKENS}),
        draft=draft)
    ModelRepository._register_disagg(
        server, "lm_disagg", lm,
        dict(geometry, **oneshot, mode="disagg", prefill_replicas=1,
             decode_replicas=1, machine_spec="machine.json"),
        model_dir=disagg_dir)
    httpd = server.serve_http(port=0)
    infer, tokens = {}, {}
    try:
        port = httpd.server_address[1]
        if loaded != ["cspec", "onnx_attention", "onnx_mlp"]:
            failures.append(f"loaded {loaded}")
        metrics = _http(port, "/metrics")[2].decode()
        if 'ff_model_load_failures_total{model="broken"} 1' not in metrics:
            failures.append("the broken entry's load failure not counted")
        feeds = {"onnx_mlp": onnx_inputs["mnist_mlp"],
                 "onnx_attention": onnx_inputs["attention"][:1],
                 "cspec": cspec_x}
        for name in loaded:
            im = server._models[name].model
            x = feeds[name]
            body = {"inputs": {im.input_names[0]: x.tolist()}}
            walls = []
            for _ in range(4):  # the first captures the bucket
                t_req = time.perf_counter()
                out = np.asarray(json.loads(_http(
                    port, f"/v2/models/{name}/infer", body)[2])["outputs"],
                    np.float32)
                walls.append((time.perf_counter() - t_req) * 1e3)
            # the entry's own predict over the bucket the request took
            rows, bucket = x.shape[0], im._bucket_for(x.shape[0])
            padded = np.concatenate(
                [x, np.zeros((bucket - rows,) + x.shape[1:], x.dtype)])
            want_out = im.model.predict(padded, batch_size=bucket)[:rows]
            err = float(np.abs(out - want_out).max())
            f32 = not im.model.config.allow_mixed_precision
            ok = (np.allclose(out, want_out, atol=IMPORT_F32_TOL,
                              rtol=IMPORT_F32_TOL) if f32 else
                  err <= IMPORT_BF16_REL * float(np.abs(want_out).max()))
            infer[name] = {"rows": rows, "bucket": bucket, "f32": f32,
                           "max_abs_err_vs_predict": err,
                           "first_ms": walls[0],
                           "steady_ms_median": float(np.median(walls[1:])),
                           "graphs": dict(im.counts)}
            if name == "cspec":
                trained_err = float(np.abs(out - cspec_trained).max())
                infer[name]["max_abs_err_vs_trained_f32"] = trained_err
                if trained_err > IMPORT_BF16_REL:
                    failures.append(f"cspec serves {trained_err} off the "
                                    f"trained model")
            if not ok or out.shape != want_out.shape:
                failures.append(f"/infer {name}: {infer[name]}")
        for name in ("lm_fleet", "lm_disagg"):
            t_req = time.perf_counter()
            got = json.loads(_http(port, f"/v2/models/{name}/generate", {
                "prompt": [p.tolist() for p in prompts],
                "max_new_tokens": REPO_NEW})[2])["tokens"]
            wall = time.perf_counter() - t_req
            ref = want["fleet" if name == "lm_fleet" else "disagg"]
            tokens[name] = {"identical": got == ref,
                            "equal_to_plain_batcher": sum(
                                a == b for a, b in zip(got, plain)),
                            "wall_s": wall,
                            "tokens_per_s": sum(map(len, got)) / wall}
            if got != ref:
                failures.append(f"{name}: tokens differ from one batcher's")
        coord = server._fleets["lm_disagg"].disagg
        deadline = time.monotonic() + 120
        while coord.committed + coord.resumed < len(prompts):
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        log = list(coord.log)
        if not log or coord.failed:
            failures.append(f"handoffs: {len(log)} logged, {coord.failed} "
                            f"failed")
        for h in log:
            if not h["predicted_us"] > 0 or \
                    h["bytes"] / h["chunks"] > TRANSFER_TIER_CHUNK_BYTES:
                failures.append(f"handoff {h}")
        spec_stats = [server._fleets["lm_fleet"].replica(n).batcher.stats()
                      .get("spec") for n in ("r0", "r1")]
        # the fleet entry's decode iteration is speculative: walk it on
        # the entry's own replica, idle now and unloaded next
        walk = _spec_iteration_launches(
            torch, server._fleets["lm_fleet"].replica("r0").batcher, 62)
        failures += _launches_wrong(
            "a fleet replica's speculative iteration", walk,
            _spec_per_walk(lm, draft, REPO_SPEC_TOKENS))
        for name in ("onnx_mlp", "lm_fleet"):
            repo.unload(server, name)
        health = json.loads(_http(port, "/healthz")[2])
        fams = validate_exposition(_http(port, "/metrics")[2].decode())
        if health["models"] != ["cspec", "onnx_attention"] or \
                "lm_fleet" in health.get("fleets", {}):
            failures.append(f"/healthz after unload {health}")
        if "ff_model_load_failures_total" not in fams:
            failures.append("/metrics lost ff_model_load_failures_total")
    finally:
        httpd.shutdown()
        server.shutdown()
    launches = {k: n for k, n in launch_counts().items() if n}
    failures += _launches_wrong(
        "the phase", launches,
        present=FLEET_ONESHOT_KERNELS + ("multiquery_decode_attention",))
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    line = {
        "phase": "repository", "card": _card_line(),
        "entries": loaded, "load_s": load_s,
        "load_failures": sorted(server._load_failures),
        "infer": infer, "generate": tokens,
        "prompts": [len(p) for p in prompts], "new_tokens": REPO_NEW,
        "spec": spec_stats, "handoffs": len(log),
        "predicted_us": [h["predicted_us"] for h in log],
        "handoff_bytes": [h["bytes"] for h in log],
        "healthz_after_unload": health["status"],
        "fleet_spec_iteration": walk,
        "wall_s": time.perf_counter() - t0,
        "tolerance": "/infer against the entry's own predict: f32 within "
                     "atol 1e-4, rtol 1e-4, bf16 max |err| <= 2e-2 max "
                     "|predict|; fleet "
                     "(speculative) and disagg (one-shot) tokens equal one "
                     "batcher's of the same geometry; every handoff priced,"
                     " <= 64 MB a chunk; /healthz and /metrics valid after "
                     "unload",
    }
    _emit(dict(line, launches=launches))
    if failures:
        raise AssertionError(f"repository: {failures}")
    return line, launches, walk


# 63) keras: the examples' models through flexflow_tpu_torch.keras
KERAS_BATCH = 64
# seq_mnist_mlp.py: 784-512-512-10, Adam 1e-3, 4 epochs over the 6,000
# synthetic samples, its 90% gate
KERAS_MNIST_EPOCHS, KERAS_MNIST_GATE = 4, 0.90
# func_cifar10_cnn.py trains 2 epochs of 50,000 samples; cut to 20 steps
KERAS_CNN_STEPS = 20
KERAS_K = 4
# the first steps of each on the card against the port's CPU run of the
# same steps in the same precision: the MLP's 40 in f32 and its first 20
# in bf16, the CNN's 8. Past ~26 steps torch's bf16 arithmetic on the
# card parts from the CPU's by up to 0.07 with no kernel of the port in
# the run (kernel_impl="reference"), as far as the bf16 runs part from
# f32; so the MLP's 40 bf16 steps through the kernels are held to the
# same card's reference lowering (the same torch ops without the kernels)
KERAS_F32_TOL, KERAS_BF16_TOL = 1e-3, 2e-2
KERAS_MLP_WITNESS, KERAS_MLP_BF16_CPU, KERAS_CNN_WITNESS = 40, 20, 8
# K = 4 against K = 1, every epoch's loss (phase 15's bound)
KERAS_K_RTOL = 1e-6
KERAS_LN_STEPS = 10
# the kernels one fit step and one predict walk of a keras model launch
# on the card (the reduce: the loss and the accuracy), nothing else of
# the table
KERAS_STEP = {"softmax_fwd": 1, "softmax_bwd": 1, "reduce": 2,
              "optimizer_adam": 1}
KERAS_PREDICT = {"softmax_fwd": 1}
KERAS_CUTS = {"cnn": f"2 epochs of 50,000 samples -> {KERAS_CNN_STEPS} "
                     f"steps of {KERAS_BATCH}",
              "elastic-dead-peer": "2-rank MLP (32-64-10, batch 12), "
                                   "the leg checks the failure path"}
KERAS_WALKS = ("mlp-fit-step", "cnn-fit-step", "mlp-predict", "cnn-predict")


def _keras_mlp(device, mixed, steps=1, kernel_impl="auto"):
    """seq_mnist_mlp.py's model (weights from compile's default
    generator, so every build draws the same)."""
    import flexflow_tpu_torch.keras as keras
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.keras.layers import Activation, Dense
    from flexflow_tpu_torch.keras.models import Sequential

    model = Sequential()
    model.add(Dense(512, activation="relu", input_shape=(784,)))
    model.add(Dense(512, activation="relu"))
    model.add(Dense(10))
    model.add(Activation("softmax"))
    model.compile(optimizer=keras.optimizers.Adam(learning_rate=1e-3),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  ffconfig=FFConfig(batch_size=KERAS_BATCH, device=device,
                                    allow_mixed_precision=mixed,
                                    kernel_impl=kernel_impl),
                  steps_per_execution=steps)
    return model


def _keras_cnn(device, mixed):
    """func_cifar10_cnn.py's functional model."""
    import flexflow_tpu_torch.keras as keras
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.keras.layers import (Activation, Conv2D, Dense,
                                                 Flatten, Input,
                                                 MaxPooling2D)
    from flexflow_tpu_torch.keras.models import Model

    inp = Input(shape=(3, 32, 32))
    t = Conv2D(32, (3, 3), padding="same", activation="relu")(inp)
    t = Conv2D(32, (3, 3), padding="same", activation="relu")(t)
    t = MaxPooling2D((2, 2))(t)
    t = Conv2D(64, (3, 3), padding="same", activation="relu")(t)
    t = Conv2D(64, (3, 3), padding="same", activation="relu")(t)
    t = MaxPooling2D((2, 2))(t)
    t = Flatten()(t)
    t = Dense(512, activation="relu")(t)
    t = Dense(10)(t)
    out = Activation("softmax")(t)
    model = Model(inputs=inp, outputs=out)
    model.compile(optimizer=keras.optimizers.Adam(learning_rate=1e-3),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  ffconfig=FFConfig(batch_size=KERAS_BATCH, device=device,
                                    allow_mixed_precision=mixed))
    return model


def _keras_data(np):
    from flexflow_tpu_torch.keras.datasets import cifar10, mnist

    (xm, ym), _ = mnist.load_data()
    xm = xm.reshape(-1, 784).astype(np.float32) / 255.0
    ym = ym.astype(np.int32).reshape(-1, 1)
    (xc, yc), _ = cifar10.load_data(num_samples=KERAS_CNN_STEPS
                                    * KERAS_BATCH)
    xc = xc.astype(np.float32) / 255.0
    yc = yc.astype(np.int32).reshape(-1, 1)
    return xm, ym, xc, yc


def _keras_walks(torch, model, x, y):
    """One fit step's and one predict walk's launches (a batch each)."""
    from flexflow_tpu_torch.kernels import launch_counts

    b = KERAS_BATCH
    before = launch_counts()
    model.ffmodel.fit(x[:b], y[:b], batch_size=b, epochs=1)
    torch.cuda.synchronize()
    step = {k: n for k, n in _launches_since(before).items() if "/" not in k}
    before = launch_counts()
    model.predict(x[:b])
    walk = {k: n for k, n in _launches_since(before).items() if "/" not in k}
    return step, walk


def _launches_exact(walk, launches, want):
    """_launches_wrong with every other kernel of the table wanted 0."""
    return _launches_wrong(walk, launches,
                           {**{k: 0 for k in launches}, **want})


def _close(a, b, tol):
    return len(a) == len(b) and all(abs(u - v) <= tol for u, v in zip(a, b))


def phase_keras(torch):
    """63: the Keras frontend on the card (see the module docstring).
    Returns the phase's record and the walks' launches."""
    import numpy as np

    import flexflow_tpu_torch.keras as keras
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.keras_exp import Model as ExpModel
    from flexflow_tpu_torch.kernels import launch_counts
    from flexflow_tpu_torch.onnx import wire

    t0 = time.perf_counter()
    xm, ym, xc, yc = _keras_data(np)
    failures, secs = [], {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        if name.endswith("card"):
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    # the MLP at the port's default bf16 at K = 1 and K = 4, and in f32;
    # the first epoch's step losses kept (fit's StepStats of that epoch)
    hist, models, first = {}, {}, {}

    class FirstEpoch(keras.callbacks.Callback):
        def __init__(self, name):
            super().__init__()
            self.name = name

        def on_epoch_end(self, epoch, logs=None):
            if epoch == 0:
                first[self.name] = [
                    r["loss"] for r in self.model.ffmodel.step_stats.records()]

    for name, mixed, k in (("mlp-f32-card", False, 1),
                           ("mlp-bf16-card", True, 1),
                           ("mlp-bf16-k4-card", True, KERAS_K)):
        models[name] = _keras_mlp("cuda", mixed, k)
        hist[name] = timed(name, lambda: models[name].fit(
            xm, ym, epochs=KERAS_MNIST_EPOCHS, batch_size=KERAS_BATCH,
            callbacks=[FirstEpoch(name)]).history)
    accuracy = {n: h["accuracy"] for n, h in hist.items()}
    for name in hist:
        if accuracy[name][-1] < KERAS_MNIST_GATE:
            failures.append(f"{name} accuracy {accuracy[name][-1]} below "
                            f"the example's gate")
    k1 = hist["mlp-bf16-card"]["loss"]
    k4 = hist["mlp-bf16-k4-card"]["loss"]
    if not all(abs(a - b) <= KERAS_K_RTOL * abs(a) for a, b in zip(k1, k4)):
        failures.append("mlp K = 4 vs K = 1")
    ms = models["mlp-bf16-k4-card"].ffmodel._multi_steps
    k_stats = {k: v.stats() for k, v in ms.items()}
    dispatches = KERAS_MNIST_EPOCHS * (len(xm) // (KERAS_BATCH * KERAS_K))
    if list(k_stats) != [KERAS_K] or k_stats[KERAS_K]["captures"] != 1 \
            or k_stats[KERAS_K]["replays"] != dispatches - 1:
        failures.append(f"K = {KERAS_K}: one capture over "
                        f"{KERAS_MNIST_EPOCHS} epochs, {dispatches - 1} "
                        f"replays expected, got {k_stats}")

    # the CNN at bf16: 20 steps on the card
    cnns = {"cnn-bf16-card": _keras_cnn("cuda", True)}
    timed("cnn-bf16-card", lambda: cnns["cnn-bf16-card"].fit(
        xc, yc, epochs=1, batch_size=KERAS_BATCH))
    first["cnn-bf16-card"] = [r["loss"] for r in cnns[
        "cnn-bf16-card"].ffmodel.step_stats.records()]
    if len(first["cnn-bf16-card"]) != KERAS_CNN_STEPS or not all(
            np.isfinite(first["cnn-bf16-card"])):
        failures.append("cnn steps")

    # a fit step's and a predict walk's launches of each (bf16, card),
    # before the witness's kernel_impl="reference" build configures
    # the registry's default (a later compile restores it)
    walks = {}
    walks["mlp-fit-step"], walks["mlp-predict"] = _keras_walks(
        torch, models["mlp-bf16-card"], xm, ym)
    walks["cnn-fit-step"], walks["cnn-predict"] = _keras_walks(
        torch, cnns["cnn-bf16-card"], xc, yc)
    for w in ("mlp-fit-step", "cnn-fit-step"):
        failures += _launches_exact(w, walks[w], KERAS_STEP)
    for w in ("mlp-predict", "cnn-predict"):
        failures += _launches_exact(w, walks[w], KERAS_PREDICT)
    predict = models["mlp-bf16-card"].predict(xm[:1000])
    if predict.shape != (1000, 10) or not np.isfinite(predict).all():
        failures.append("mlp predict")
    del models, cnns

    # the witness: each model's first steps from the same weights and
    # batches on the card and on the CPU, in both precisions, and the
    # MLP's bf16 steps on the card's reference lowering
    witness = {}

    def steps_of(name, m, x, y, steps):
        n = steps * KERAS_BATCH
        timed(name, lambda: m.fit(x[:n], y[:n], epochs=1,
                                  batch_size=KERAS_BATCH))
        witness[name] = [r["loss"] for r in m.ffmodel.step_stats.records()]

    for net, build, x, y, steps in (
            ("mlp", _keras_mlp, xm, ym, KERAS_MLP_WITNESS),
            ("cnn", _keras_cnn, xc, yc, KERAS_CNN_WITNESS)):
        for prec, mixed in (("bf16", True), ("f32", False)):
            for where in ("card", "cpu"):
                name = f"{net}-{prec}-{where}"
                if name in first:
                    witness[name] = first[name][:steps]
                else:
                    steps_of(name, build("cuda" if where == "card"
                                         else "cpu", mixed), x, y, steps)
            tol = KERAS_BF16_TOL if prec == "bf16" else KERAS_F32_TOL
            n = KERAS_MLP_BF16_CPU if (net, prec) == ("mlp", "bf16") \
                else steps
            if not _close(witness[f"{net}-{prec}-card"][:n],
                          witness[f"{net}-{prec}-cpu"][:n], tol):
                failures.append(f"{net} {prec} card vs CPU")
    steps_of("mlp-bf16-card-reference",
             _keras_mlp("cuda", True, kernel_impl="reference"), xm, ym,
             KERAS_MLP_WITNESS)
    if not _close(witness["mlp-bf16-card"],
                  witness["mlp-bf16-card-reference"], KERAS_BF16_TOL):
        failures.append("mlp bf16 kernels vs the card's reference")
    gaps = {f"{a} vs {b}": max(abs(u - v) for u, v in zip(
        witness[a], witness[b])) for a, b in (
            ("mlp-bf16-card", "mlp-bf16-cpu"),
            ("mlp-bf16-card-reference", "mlp-bf16-cpu"),
            ("mlp-bf16-card", "mlp-bf16-card-reference"),
            ("mlp-bf16-cpu", "mlp-f32-cpu"),
            ("mlp-f32-card", "mlp-f32-cpu"),
            ("cnn-bf16-card", "cnn-bf16-cpu"),
            ("cnn-f32-card", "cnn-f32-cpu"))}

    # a Sequential with LayerNormalization: the LayerNorm kernels through
    # Keras
    from flexflow_tpu_torch.keras.layers import (Activation, Dense,
                                                 LayerNormalization)
    from flexflow_tpu_torch.keras.models import Sequential

    before = launch_counts()
    ln = Sequential()
    ln.add(Dense(512, activation="relu", input_shape=(784,)))
    ln.add(LayerNormalization())
    ln.add(Dense(10))
    ln.add(Activation("softmax"))
    ln.compile(optimizer=keras.optimizers.Adam(learning_rate=1e-3),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"],
               ffconfig=FFConfig(batch_size=KERAS_BATCH, device="cuda"))
    n_ln = KERAS_LN_STEPS * KERAS_BATCH
    ln_hist = timed("layernorm-card", lambda: ln.fit(
        xm[:n_ln], ym[:n_ln], epochs=1, batch_size=KERAS_BATCH).history)
    ln_pred = ln.predict(xm[:KERAS_BATCH])
    ln_launches = {k: n for k, n in _launches_since(before).items()
                   if "/" not in k}
    # each step one LayerNorm forward and backward beside a fit step's
    # kernels; the predict walk one LayerNorm and one softmax forward
    failures += _launches_exact("layernorm", ln_launches, {
        **{k: n * KERAS_LN_STEPS for k, n in KERAS_STEP.items()},
        "layernorm_fwd": KERAS_LN_STEPS + 1,
        "layernorm_bwd": KERAS_LN_STEPS,
        "softmax_fwd": KERAS_LN_STEPS + 1})
    if not np.isfinite(ln_hist["loss"]).all() or \
            not np.isfinite(ln_pred).all():
        failures.append("layernorm model not finite")

    # keras_exp: 59's ONNX MNIST MLP, build, compile, fit, predict (f32)
    proto, inits, ref = _mnist_onnx(np, wire)
    em = ExpModel(proto, batch_size=MNIST_BATCH,
                  config=FFConfig(device="cuda",
                                  allow_mixed_precision=False))
    ffm = em.build([[MNIST_BATCH, MNIST_WIDTHS[0]]])
    em.compile(optimizer=AdamOptimizer(ffm, alpha=1e-3),
               metrics=[])
    x_exp = xm[:10 * MNIST_BATCH]
    exp_err = float(np.abs(ffm.predict(x_exp) - ref(x_exp)).max())
    exp_hist = timed("keras-exp-card", lambda: em.fit(
        x_exp, ym[:10 * MNIST_BATCH], batch_size=MNIST_BATCH, epochs=2))
    exp_after = ffm.predict(x_exp)
    if exp_err > 1e-4 or not np.isfinite(exp_after).all() or \
            exp_hist[-1]["loss"] >= exp_hist[0]["loss"]:
        failures.append(f"keras_exp: predict err {exp_err}, losses "
                        f"{[h['loss'] for h in exp_hist]}")

    line = {"phase": "keras", "card": _card_line(),
            "mlp_accuracy_by_epoch": accuracy,
            "mlp_epoch_losses": {n: h["loss"] for n, h in hist.items()},
            "mlp_k_stats": k_stats,
            "cnn_losses": first["cnn-bf16-card"], "witness": witness,
            "witness_max_gaps": gaps,
            "layernorm_losses": ln_hist["loss"],
            "keras_exp_predict_max_abs_err": exp_err,
            "keras_exp_losses": [h["loss"] for h in exp_hist],
            "walks": walks, "layernorm_launches": ln_launches,
            "seconds": secs, "cuts": {"cnn": KERAS_CUTS["cnn"]},
            "wall_s": time.perf_counter() - t0,
            "gate": f"accuracy >= {KERAS_MNIST_GATE} after "
                    f"{KERAS_MNIST_EPOCHS} epochs at the port's default "
                    f"bf16 (K = 1 and K = {KERAS_K}) and in f32",
            "tolerance": f"step losses on the card within "
                         f"{KERAS_F32_TOL} (f32) and {KERAS_BF16_TOL} "
                         f"(bf16) of the port's CPU run: the MLP's first "
                         f"{KERAS_MLP_WITNESS} in f32 and "
                         f"{KERAS_MLP_BF16_CPU} in bf16, the CNN's first "
                         f"{KERAS_CNN_WITNESS}; the MLP's first "
                         f"{KERAS_MLP_WITNESS} bf16 within "
                         f"{KERAS_BF16_TOL} of the card's reference "
                         f"lowering; every epoch's loss at K = "
                         f"{KERAS_K} within "
                         f"{KERAS_K_RTOL} relative of K = 1; keras_exp "
                         f"predict within 1e-4 of numpy (f32)"}
    _emit(line)
    if failures:
        raise AssertionError(f"keras: {failures}")
    return line, walks


def phase_elastic_dead_peer(torch):
    """64: two ranks over gloo sharing the card (see the module
    docstring)."""
    import numpy as np

    from flexflow_tpu_torch.elastic.faults import classify_error
    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    x = rng.randn(48, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(48, 1)).astype(np.int32)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ff_dead_peer_") as tmp:
        jobs = [{"collective_timeout": {"timeout_s": 1.0}},
                {"elastic": {"batch": 12,
                             "config": {"search_budget": 0,
                                        "measure_op_costs": False},
                             "device_ids": [0, 1],
                             "coordinator": {"checkpoint_every": 2},
                             "checkpoint_dir": os.path.join(tmp, "ckpt"),
                             "x": x, "y": y, "steps": 6,
                             "exit_in_allreduce": (1, 2)}}]
        ranks = spawn_jobs(2, "cuda", jobs, timeout_s=DEAD_PEER_LIMIT_S,
                           workdir=tmp, leavers=(1,))
    timeout, run = ranks[0]["jobs"]
    detect = [e for e in run["events"] if e[0] == "detect.topology_loss"]
    err = detect[0][2]["error"] if detect else ""
    failures = []
    if ranks[1] is not None:
        failures.append("rank 1 did not exit")
    if timeout["classes"] != ["transient", "topology"] or \
            "Timed out waiting" not in timeout["errors"][0] or \
            "pair closure" not in timeout["errors"][1] or \
            not (timeout["raised"] or "").startswith("TopologyLoss: "):
        failures.append(f"timeout: {timeout}")
    if [(e[1], e[2]["chips"]) for e in detect] != [(2, [])] or \
            classify_error(RuntimeError(err)) != "topology":
        failures.append(f"detect: {detect}")
    raised = run["raised"] or ""
    if not raised.startswith("RecoveryFailed: ") or \
            "restart from the latest checkpoint" not in raised:
        failures.append(f"raised: {raised!r}")
    line = {"phase": "elastic-dead-peer", "card": _card_line(),
            "timeout_errors": timeout["errors"],
            "timeout_classes": timeout["classes"],
            "timeout_waits_s": timeout["waits_s"],
            "timeout_raised": timeout["raised"],
            "detect": detect, "raised": raised,
            "model_device": run["model_device"],
            "cut": KERAS_CUTS["elastic-dead-peer"],
            "limit_s": DEAD_PEER_LIMIT_S,
            "wall_s": time.perf_counter() - t0}
    _emit(line)
    if failures:
        raise AssertionError(f"elastic-dead-peer: {failures}")
    return line


# the spawn's limit: past it the spawn stops both ranks and raises
DEAD_PEER_LIMIT_S = 120


# phase 65: the command line's serve-bench at the flagship serving
# widths, max_len = 448 + 64 = 512 as in phases 16-19
CLI_SERVE = ["serve-bench", "--hidden", "1024", "--heads", "16",
             "--layers", "12", "--vocab", "30522", "--slots", "8",
             "--page-size", "16", "--prompt-min", "64", "--prompt-max",
             "448", "--out-min", "16", "--out-max", "64", "--requests", "16"]
CLI_CONTINUOUS_KERNELS = ("decode_attention", "multiquery_decode_attention",
                          "layernorm_fwd", "softmax_fwd")
CLI_LOCKSTEP_KERNELS = ("flash_fwd",)
# profile's training step: the flagship's, with SGD's one update
CLI_PROFILE = ["profile", "--model", "bert", "-b", "8"]
CLI_STEP = {k: n for k, n in TRAIN_PER_STEP.items() if k != "optimizer_adam"}
CLI_STEP["optimizer_sgd"] = 1
CLI_ANALYZE = ["analyze", "--model", "bert", "--chips", "8", "--strategy",
               "examples/strategies/bert_8dev.json", "--json"]
BERT_ENV = ("FF_BERT_HIDDEN", "FF_BERT_HEADS", "FF_BERT_LAYERS",
            "FF_BERT_SEQ", "FF_BERT_VOCAB")
# appended to every subcommand's argv: empty, so each runs on the card
CLI_DEVICE = []


def _cli(argv, out=None):
    """main(argv) in this process: its exit code from the SystemExit a
    subcommand raises (0 where it returns); stdout to `out` when given."""
    import contextlib
    import io

    from flexflow_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf if out is None else out):
        try:
            main(list(argv) + CLI_DEVICE)
            code = 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue()


def _counted(owner, name, into):
    """Wrap owner.name so each call adds its launches to `into` (a list of
    per-call dicts, routes left out); returns the restore."""
    from flexflow_tpu_torch.kernels import launch_counts

    fn = getattr(owner, name)

    def wrapped(*a, **kw):
        before = launch_counts()
        try:
            return fn(*a, **kw)
        finally:
            after = launch_counts()
            into.append({k: n - before.get(k, 0) for k, n in after.items()
                         if n > before.get(k, 0) and "/" not in k})

    setattr(owner, name, wrapped)
    return lambda: setattr(owner, name, fn)


def phase_cli(torch, tmp):
    """65: the command line in this process (see the module docstring).
    Returns (line, {path: launches}) for the kernel table."""
    import flexflow_tpu_torch.obs as obs
    import flexflow_tpu_torch.serving.sched.bench as sbench
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.obs.cli import validate_trace

    failures = []
    seconds = {}
    repo = os.path.dirname(os.path.abspath(__file__))

    # serve-bench: the continuous batcher, then the lockstep session
    t0 = time.perf_counter()
    cont, lock = [], []
    undo = [_counted(sbench, "run_continuous", cont),
            _counted(sbench, "run_lockstep", lock)]
    report = os.path.join(tmp, "serve_bench.json")
    reset_launch_counts()
    try:
        code, text = _cli(CLI_SERVE + ["--report", report])
    finally:
        for u in undo:
            u()
    serve_all = {k: n for k, n in launch_counts().items()
                 if n and "/" not in k}
    seconds["serve-bench"] = time.perf_counter() - t0
    print(text, end="", flush=True)
    if code != 0:
        failures.append(f"serve-bench exited {code}")
    rep = json.load(open(report)) if os.path.exists(report) else {}
    c, base = rep.get("continuous", {}), rep.get("lockstep", {})
    cfg = rep.get("config", {})
    requested = sum(w["max_new"] for w in sbench.make_workload(
        cfg.get("requests", 0), cfg.get("prompt_min", 0),
        cfg.get("prompt_max", 0), cfg.get("out_min", 0),
        cfg.get("out_max", 0), cfg.get("vocab", 2), cfg.get("seed", 0)))
    if c.get("tokens") != requested or c.get("dropped"):
        failures.append(f"serve-bench: {c.get('tokens')} of {requested} "
                        f"tokens, {c.get('dropped')} dropped")
    cont_l = cont[0] if cont else {}
    lock_l = lock[0] if lock else {}
    failures += _launches_wrong("serve-bench continuous", cont_l,
                                present=CLI_CONTINUOUS_KERNELS)
    failures += _launches_wrong("serve-bench lockstep", lock_l,
                                present=CLI_LOCKSTEP_KERNELS)
    serve = {"tokens_per_s": c.get("tokens_per_s"),
             "lockstep_tokens_per_s": base.get("tokens_per_s"),
             "speedup": rep.get("speedup"),
             "ttft_ms_p50": c.get("ttft_ms_p50"),
             "ttft_ms_p95": c.get("ttft_ms_p95"),
             "ttft_ms_p99": c.get("ttft_ms_p99"),
             "latency_ms_p50": c.get("latency_ms_p50"),
             "latency_ms_p95": c.get("latency_ms_p95"),
             "tokens": c.get("tokens"), "requested": requested,
             "exit_code": code, "continuous_launches": cont_l,
             "lockstep_launches": lock_l}

    # profile: the flagship's widths, the default (mixed precision) config
    t0 = time.perf_counter()
    for k in BERT_ENV:
        os.environ.pop(k, None)
    out_dir = os.path.join(tmp, "profile_out")
    fits, cals = [], []
    undo = [_counted(FFModel, "fit", fits), _counted(obs, "calibrate", cals)]
    log = open(os.path.join(tmp, "profile.txt"), "w")
    try:
        code, _ = _cli(CLI_PROFILE + ["--out", out_dir], out=log)
    finally:
        log.close()
        for u in undo:
            u()
    seconds["profile"] = time.perf_counter() - t0
    lines = open(os.path.join(tmp, "profile.txt")).read().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    bench = (json.load(open(os.path.join(out_dir, "bench.json")))
             if os.path.exists(os.path.join(out_dir, "bench.json")) else {})
    if code != 0 or not summary.get("ok"):
        failures.append(f"profile exited {code}: "
                        f"{summary.get('problems')}")
    steps = summary.get("steps_recorded") or 0
    fit_l = fits[0] if fits else {}
    want = {k: n * steps for k, n in CLI_STEP.items()}
    failures += _launches_wrong("profile fit", fit_l, want)
    if not steps or set(fit_l) - set(want):
        failures.append(f"profile fit: {steps} steps, launches {fit_l}")
    profile = {"exit_code": code, "ok": summary.get("ok"),
               "spans": summary.get("spans"), "steps_recorded": steps,
               "samples_per_s": bench.get("value"), "mfu": bench.get("mfu"),
               "predicted_step_us": bench.get("predicted_step_us"),
               "measured_step_us": bench.get("measured_step_us"),
               "step_ratio": bench.get("step_ratio"),
               "backend": bench.get("backend"),
               "fit_launches": fit_l,
               "step_launches": {k: n / steps for k, n in fit_l.items()}
               if steps else {},
               "calibrate_launches": cals[0] if cals else {},
               "problems": summary.get("problems")}

    # analyze: in process, then through the module entry
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        code, text = _cli(CLI_ANALYZE)
    finally:
        os.chdir(cwd)
    doc = json.loads(text) if code == 0 else {}
    if code != 0 or not doc.get("ok"):
        failures.append(f"analyze exited {code}")
    proc = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch"]
                          + CLI_ANALYZE + CLI_DEVICE, capture_output=True,
                          text=True,
                          timeout=300, cwd=repo)
    if proc.returncode != 0 or not json.loads(proc.stdout).get("ok"):
        failures.append(f"python -m analyze exited {proc.returncode}: "
                        f"{proc.stderr[-2000:]}")
    analyze = {"exit_code": code, "python_m_exit_code": proc.returncode,
               "errors": doc.get("errors"), "warnings": doc.get("warnings"),
               "passes_run": doc.get("passes_run")}
    seconds["analyze"] = time.perf_counter() - t0

    # timeline over the profile's trace
    t0 = time.perf_counter()
    merged = os.path.join(tmp, "timeline.json")
    code, text = _cli(["timeline", "--trace",
                       os.path.join(out_dir, "trace.json"), "--out", merged])
    try:
        merged_spans = validate_trace(merged)
    except (OSError, ValueError, KeyError) as e:
        merged_spans = None
        failures.append(f"timeline: {e}")
    if code != 0:
        failures.append(f"timeline exited {code}")
    timeline = {"exit_code": code, "summary": json.loads(
        text.strip().splitlines()[-1]) if code == 0 else None,
        "valid_span_names": len(merged_spans or [])}
    seconds["timeline"] = time.perf_counter() - t0

    line = {"phase": "cli", "card": _card_line(), "serve_bench": serve,
            "profile": profile, "analyze": analyze, "timeline": timeline,
            "seconds": seconds, "wall_s": sum(seconds.values())}
    _emit(line)
    if failures:
        raise AssertionError(f"cli: {failures}")
    return line, {"cli-serve-bench": serve_all, "cli-profile-fit": fit_l}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import _build, launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    t_start = time.perf_counter()
    # 1) device. f32 products in full f32 (no TF32) on both paths; the
    # serving path itself is bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    _emit({"phase": "device", "name": torch.cuda.get_device_name(0),
           "nvidia_smi": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2) build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [line.strip() for log in _build.BUILD_INFO.get("ptxas", {}).values()
             for line in log.splitlines()
             if "registers" in line or "Compiling entry" in line]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "compiled": _build.BUILD_INFO["compiled"], "ptxas": ptxas})

    # 3) kernels
    from flexflow_tpu_torch.kernels import flash_attention as fa
    reset_launch_counts()
    table = phase_kernels(torch, F)
    from flexflow_tpu_torch.kernels import decode as dec
    from flexflow_tpu_torch.kernels import norm, reduction
    _emit({"phase": "kernels", "table": table,
           # the decode and flash calls of this phase by route: tc the
           # bf16 tensor-core kernels, cc the CUDA-core ones; softmax and
           # RMSNorm forward, LayerNorm backward and the reduce by their
           # plans' routes
           "decode_routes": dict(dec.ROUTES),
           "flash_routes": dict(fa.ROUTES),
           "norm_routes": dict(norm.ROUTES),
           "reduce_routes": dict(reduction.ROUTES),
           "flash_tc_ptxas": fa.tc_kernel_report(),
           # empty where this process loaded a library built earlier
           "norm_fwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith(("softmax_", "rmsnorm_warp",
                                          "rmsnorm_block", "layernorm_fwd"))
               and not r["kernel"].startswith("softmax_bwd")],
           # layernorm_bwd_warp_kernel<T, V, false> is RMSNorm's backward
           "ln_bwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith(("layernorm_bwd", "rmsnorm_bwd",
                                          "ln_column_sums"))],
           # the register and loop routes, and the rows route at the
           # paths' (lanes, values a lane): (2, 1) and (16, 1)
           "softmax_bwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith("softmax_bwd_") and (
                   not r["kernel"].startswith("softmax_bwd_rows")
                   or r["kernel"].endswith((", 2, 1>", ", 16, 1>")))],
           "reduce_ptxas": [r for r in _build.ptxas_report("reduction.cu")
                            if r["kernel"].startswith(("reduce_",
                                                       "cumsum_"))]})

    # 4) serve: full width, random weights from a fixed generator
    hidden, heads, layers, vocab, window = 1024, 16, 12, 30522, 512
    num_slots, max_len, page = 8, 1024, 16
    t0 = time.perf_counter()
    lm = build_tiny_lm(num_slots, window, vocab=vocab, hidden=hidden,
                       heads=heads, layers=layers, mixed_precision=True,
                       device="cuda",
                       generator=torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for ws in lm.params.values()
                   for t in ws.values())
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    # the default batcher: the decode iteration and every slot's prefill
    # chunk as CUDA graphs, the prefix cache on. The launch counts cover
    # the warm-up, which captures the graphs (a replay runs no wrapper)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    cb = ContinuousBatcher(lm, max_len=max_len, num_slots=num_slots,
                           page_size=page)
    cb.start()
    # one a slot, so every graph is captured; the first drawn from `rng`
    # as the earlier single warm-up request was, the rest from their own
    # stream, so the timed mix stays the one earlier runs served
    warm_rng = np.random.RandomState(1)
    warm = [cb.submit((rng if i == 0 else warm_rng).randint(
        0, vocab, size=40), 4) for i in range(num_slots)]
    for r in warm:
        r.result(timeout=600)
    warm_stats = cb.stats()
    warm_graphs = dict(warm_stats["graphs"])
    plens = rng.randint(32, 513, size=16)
    news = rng.randint(32, 65, size=16)
    prompts = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
               for n in plens]
    t0 = time.perf_counter()
    reqs = [cb.submit(p, int(n)) for p, n in zip(prompts, news)]
    outs = [r.result(timeout=900) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cb.stop()
    stats = cb.stats()
    launches = launch_counts()
    timed_graphs = {k: v - warm_graphs[k] for k, v in stats["graphs"].items()}
    if (timed_graphs["replays"] == 0 or any(
            timed_graphs[k] for k in ("warmups", "captures", "eager_walks"))
            or warm_graphs["eager_walks"]):
        raise AssertionError(f"the timed serve run must only replay graphs "
                             f"(warm-up {warm_graphs}, timed {timed_graphs})")
    for r, out, n in zip(reqs, outs, news):
        if len(out) != int(n):
            raise AssertionError(f"request {r.id}: {len(out)} tokens, "
                                 f"expected {int(n)}")
        if out.min() < 0 or out.max() >= vocab:
            raise AssertionError(f"request {r.id}: token out of range")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    # bf16 caches, head dim 64: every decode call on the tensor-core route
    off_route = {k: (launches[k], launches[f"{k}/tc"])
                 for k in ("decode_attention", "multiquery_decode_attention")
                 if launches[f"{k}/tc"] != launches[k]}
    if off_route:
        raise AssertionError(f"decode calls (all, tc) off the tensor-core "
                             f"route on the serving path: {off_route}")
    # the LM head's softmax over the vocabulary, 8 decode rows or 16 rows
    # of a prefill chunk: every call split over a thread-block cluster
    softmax_routes = {k: n for k, n in launches.items()
                      if k.startswith("softmax_fwd/")}
    if softmax_routes["softmax_fwd/cluster"] != launches["softmax_fwd"]:
        raise AssertionError(f"softmax_fwd calls off the cluster route on "
                             f"the serving path: {softmax_routes}")
    # LayerNorm forward over 8 decode rows or 16 rows of a prefill chunk of
    # the hidden width: every call a warp a row
    if launches["layernorm_fwd/warp"] != launches["layernorm_fwd"]:
        raise AssertionError(
            f"layernorm_fwd calls off the warp route on the serving path: "
            f"{launches['layernorm_fwd/warp']} of "
            f"{launches['layernorm_fwd']}")
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    generated = int(sum(len(o) for o in outs))
    serve = {
        "phase": "serve", "params": n_params, "model_build_s": build_s,
        "requests": len(reqs), "prompt_tokens": int(plens.sum()),
        "generated_tokens": generated, "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_iter_ms": stats["decode_iter_s_mean"] * 1e3,
        "decode_iter_ms_timed": _timed_decode_ms(warm_stats, stats),
        "decode_iterations": stats["decode_iterations"],
        "prefill_chunks": stats["prefill_chunks"],
        "graphs_warmup": warm_graphs, "graphs_timed": timed_graphs,
        "prefix": stats["pool"]["prefix"],
        "launches_cover": "the warm-up only (8 requests: the eager "
                          "warm-up and the capture of the decode graph and "
                          "of each slot's chunk graph); the timed run only "
                          "replays, which counts nothing here (serve-graph "
                          "holds a replay's device kernels against a walk's "
                          "launches)",
        "decode_routes": {k: launches[k] for k in launches
                          if k.startswith(("decode_attention/",
                                           "multiquery_decode_attention/"))},
        "softmax_routes": softmax_routes,
        "layernorm_fwd_routes": {k: n for k, n in launches.items()
                                 if k.startswith("layernorm_fwd/")},
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    _emit(serve)

    # 5) cross-check: the same weights on the CPU, plain versions
    cpu = build_tiny_lm(num_slots, window, vocab=vocab, hidden=hidden,
                        heads=heads, layers=layers, mixed_precision=True,
                        device="cpu",
                        generator=torch.Generator().manual_seed(1))
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in lm.params.items()})
    cross = []
    for plen in (40, 75):
        prompt = rng.randint(0, vocab, size=plen).astype(np.int32)
        p_gpu = _prefill_probs(torch, lm, prompt, page, 128)
        p_cpu = _prefill_probs(torch, cpu, prompt, page, 128)
        if not (torch.isfinite(p_gpu).all() and p_gpu.shape == (vocab,)):
            raise AssertionError("non-finite or misshapen probabilities")
        err = float((p_gpu - p_cpu).abs().max())
        tol = 0.05 * float(p_cpu.max())
        cross.append({"prompt_len": plen, "max_abs_err": err,
                      "tolerance": tol, "max_prob": float(p_cpu.max()),
                      "sum": float(p_gpu.sum()),
                      "argmax_agrees": int(p_gpu.argmax()) == int(
                          p_cpu.argmax())})
        if err > tol:
            raise AssertionError(f"card vs CPU first-token probabilities: "
                                 f"{cross[-1]}")
    # the same, the card's probabilities read from the serve batcher's
    # captured chunk graph (slot 0 replayed chunk by chunk)
    for plen in (40, 75):
        prompt = rng.randint(0, vocab, size=plen).astype(np.int32)
        with torch.no_grad():
            for off in range(0, plen, page):
                n = min(page, plen - off)
                host = np.zeros(page + 1, np.int32)
                host[:n] = prompt[off:off + n]
                host[page] = off
                cb._chunk_dispatch(0, host)
            p_gpu = cb._chunk_probs[0, n - 1].float().cpu()
        p_cpu = _prefill_probs(torch, cpu, prompt, page, 128)
        err = float((p_gpu - p_cpu).abs().max())
        tol = 0.05 * float(p_cpu.max())
        cross.append({"prompt_len": plen, "captured_chunk": True,
                      "max_abs_err": err, "tolerance": tol,
                      "max_prob": float(p_cpu.max()),
                      "sum": float(p_gpu.sum()),
                      "argmax_agrees": int(p_gpu.argmax()) == int(
                          p_cpu.argmax())})
        if not torch.isfinite(p_gpu).all() or err > tol:
            raise AssertionError(f"captured chunk vs CPU first-token "
                                 f"probabilities: {cross[-1]}")
    if cb.stats()["graphs"]["captures"] != stats["graphs"]["captures"]:
        raise AssertionError("the cross-check re-captured a chunk graph")
    # the 16 requests' first-token probabilities through the same captured
    # chunk graph, which phase 34 holds the derived-slot batcher's against
    serve_probs = _first_token_probs(torch, cb, prompts, page)
    del cb
    _emit({"phase": "cross", "checks": cross,
           "tolerance": "max|p_card - p_cpu| <= 0.05 * max(p_cpu)",
           "seconds_since_start": time.perf_counter() - t_start})
    del cpu

    # 6) train, 7) train-witness, 8) train-cross
    train, init = phase_train(torch)
    _emit(train)
    _emit(dict(phase_train_witness(torch, init, train["losses"]),
               seconds_since_start=time.perf_counter() - t_start))
    del init
    train_cross = phase_train_cross(torch)
    _emit(dict(train_cross,
               seconds_since_start=time.perf_counter() - t_start))

    # 9) tier, 10) ref-vs-kernel
    tier = phase_tier(torch)
    _emit(dict(tier, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_ref_vs_kernel(torch),
               seconds_since_start=time.perf_counter() - t_start))

    # 11) standalone, 12) tp, 13) tp-cross
    standalone = phase_standalone(torch)
    _emit(dict(standalone, seconds_since_start=time.perf_counter() - t_start))
    tp, tp_cross, tp_launches = phase_tp(torch, train["losses"],
                                         train_cross["card"])
    _emit(dict(tp, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(tp_cross, seconds_since_start=time.perf_counter() - t_start))

    # 14) train-graph, 15) mlp
    train_graph = phase_train_graph(torch)
    _emit(dict(train_graph, seconds_since_start=time.perf_counter() - t_start))
    mlp = phase_mlp(torch)
    _emit(dict(mlp, seconds_since_start=time.perf_counter() - t_start))

    # 16) serve-graph, 17) generate, 18) oneshot, 19) prefix, 20) spec: the
    # serve LM
    serving_paths = {}
    for name, fn in (
            ("serve-graph", lambda: phase_serve_graph(torch, lm, max_len,
                                                      page)),
            ("generate", lambda: phase_generate(torch, lm, vocab)),
            ("oneshot", lambda: phase_oneshot(
                torch, lm, max_len, page, prompts[:8],
                [int(n) for n in news[:8]], outs[:8])),
            ("prefix", lambda: phase_prefix(torch, lm, max_len, page,
                                            vocab)),
            ("spec", lambda: phase_spec(torch, lm, max_len, page, vocab,
                                        prompts, news, outs, serve))):
        reset_launch_counts()
        line = fn()
        counts = launch_counts()
        missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: "
                                 f"{missing}")
        serving_paths[name] = {k: counts[k] for k in PATH_KERNELS[name]}
        _emit(dict(line, launches=serving_paths[name],
                   seconds_since_start=time.perf_counter() - t_start))

    # 21) resnet, 22) nmt, 23) dlrm, 24) dropout, then the other builders
    # and the f32 witnesses: the model zoo. Launches: each path's eager
    # run, counted from 0 just before its fit
    zoo_paths = {}
    for fn in (phase_resnet, phase_nmt, phase_dlrm, phase_dropout,
               phase_zoo):
        line = fn(torch)
        runs = ([line["eager"]] if "eager" in line else
                list(line.get("runs", line.get("models", {})).values()))
        zoo_paths[line["phase"]] = {
            k: sum(r["launches"].get(k, 0) for r in runs)
            for k in {k for r in runs for k in r["launches"]}}
        if "inference_flash_launches" in line:
            zoo_paths["dropout-inference"] = {
                "flash_fwd": line["inference_flash_launches"]}
        _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_zoo_witness(torch),
               seconds_since_start=time.perf_counter() - t_start))

    # 25) moe-switch, 26) moe-serve, 27) moe-witness: mixture of experts
    line = phase_moe_switch(torch)
    zoo_paths["moe-switch"] = line["eager"]["launches"]
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    line = phase_moe_serve(torch, serve, prompts, news)
    serving_paths["moe-serve"] = line["launches"]
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_moe_witness(torch),
               seconds_since_start=time.perf_counter() - t_start))

    # 28) predict, 29) manual, 30) checkpoint: the rest of the FFModel API,
    # durable checkpoints and tracing
    t_api = time.perf_counter()
    predict = phase_predict(torch)
    for name in PREDICT_PER_BATCH:
        zoo_paths[f"predict-{name}"] = predict[name]["launches"]
    _emit(dict(predict, seconds_since_start=time.perf_counter() - t_start))
    manual = phase_manual(torch)
    zoo_paths["manual"] = manual["launches"]
    _emit(dict(manual, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_checkpoint(torch, lm),
               seconds_since_start=time.perf_counter() - t_start))
    print(f"phases 28-30: {time.perf_counter() - t_api:.1f} s", flush=True)

    # 31) server, 32) fold: the serving front end
    t_front = time.perf_counter()
    line = phase_server(torch, lm, predict)
    zoo_paths["server-buckets"] = line["launches"]
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    line = phase_fold(torch, predict)
    for stage in ("before", "after"):
        zoo_paths[f"fold-stem-{stage}"] = line["bn_stem"][stage]["launches"]
    zoo_paths["fold-resnet50"] = line["resnet50"]["launches"]
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    print(f"phases 31-32: {time.perf_counter() - t_front:.1f} s", flush=True)

    # 33) cost, 34) slots: the cost model, its calibration loop, and the
    # batcher that sizes its slots from the machine model
    t_cost = time.perf_counter()
    reset_launch_counts()
    line = phase_cost(torch, train)
    zoo_paths["cost"] = {k: n for k, n in launch_counts().items() if n}
    _emit(dict(line, launches=zoo_paths["cost"],
               seconds_since_start=time.perf_counter() - t_start))
    line = phase_slots(torch, lm, max_len, page, vocab, prompts, news,
                       serve, serve_probs)
    serving_paths["slots"] = line["launches"]
    table["decode_attention"]["derived_slots_shape"] = \
        line["decode_kernel_at_slots"]["bfloat16"]
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    print(f"phases 33-34: {time.perf_counter() - t_cost:.1f} s", flush=True)

    # 35) search: compile() searches on the card's measured op costs and
    # trains the searched plan on four ranks
    t_search = time.perf_counter()
    line, zoo_paths["search"] = phase_search(torch, train["losses"])
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    print(f"phase 35: {time.perf_counter() - t_search:.1f} s", flush=True)

    # 36-46) the other mesh axes: seq (ring, Ulysses), expert, the row
    # pair with K = 2, attr and stage (its checkpoint), and A8.2's
    # explicit grad sync, live reshard, TASO-rule search and collective
    # sweep, on four ranks in one spawn
    t_axes = time.perf_counter()
    records, axes_launches = phase_axes(torch)
    for line in records:
        _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    for leg, counts in axes_launches.items():
        zoo_paths[f"axes-{leg}"] = counts
    legs_s = next(r["legs_s"] for r in records if "legs_s" in r)
    print(f"phases 36-49: {time.perf_counter() - t_axes:.1f} s (47-49: "
          f"{legs_s:.1f} s)", flush=True)

    # 50) resize: the serving mesh's live resize on one card
    t_resize = time.perf_counter()
    reset_launch_counts()
    line = phase_resize(torch)
    zoo_paths["resize"] = {k: n for k, n in launch_counts().items()
                           if n and "/" not in k}
    missing = [k for k in SERVE_KERNELS if not zoo_paths["resize"].get(k)]
    if missing:
        raise AssertionError(f"resize: kernels never launched: {missing}")
    _emit(dict(line, launches=zoo_paths["resize"],
               seconds_since_start=time.perf_counter() - t_start))
    print(f"phase 50: {time.perf_counter() - t_resize:.1f} s", flush=True)

    # 51) elastic-live, 52) elastic-disk: the elastic coordinator on four
    # ranks sharing the card, in a spawn of their own; 53) elastic-nan on
    # one card; 54) elastic-drill. Launches: rank 0's (the survivors'
    # first rank) over each recovered fit, counted from 0 at its start
    t_elastic = time.perf_counter()
    live, disk, elastic_launches = phase_elastic(torch)
    _emit(dict(live, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(disk, seconds_since_start=time.perf_counter() - t_start))
    for path, counts in elastic_launches.items():
        zoo_paths[path] = {k: n for k, n in counts.items() if "/" not in k}
    line, counts = phase_elastic_nan(torch)
    zoo_paths["elastic-nan"] = {k: n for k, n in counts.items()
                                if "/" not in k}
    _emit(dict(line, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_elastic_drill(torch),
               seconds_since_start=time.perf_counter() - t_start))
    print(f"phases 51-54: {time.perf_counter() - t_elastic:.1f} s",
          flush=True)

    # 55) fleet, 56) chaos, 57) disagg, 58) fleet-server: the serving
    # fleet (serving/fleet/) of two replicas sharing the serve LM on the
    # card. Launches: each phase's runs, counted from 0 at its start
    t_fleet = time.perf_counter()
    import gc

    lm32 = _fleet_lm_f32(torch)
    line, counts, fleet_mix, ref32 = phase_fleet(torch, lm, lm32, vocab)
    serving_paths["fleet"] = counts
    fleet_walks = line["launches_per_walk"]
    line, serving_paths["chaos"] = phase_chaos(torch, lm32, fleet_mix,
                                                ref32)
    del lm32
    gc.collect()
    torch.cuda.empty_cache()
    line, serving_paths["disagg"] = phase_disagg(torch, lm, vocab)
    line, serving_paths["fleet-server"] = phase_fleet_server(torch, lm)
    fleet_walks["oneshot"] = line["launches_per_walk"]["oneshot"]
    print(f"phases 55-58: {time.perf_counter() - t_fleet:.1f} s, "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)

    # 59) onnx, 60) fx, 61) cspec, 62) repository: the graph importers
    # and the model repository. Launches: each phase's runs, counted from
    # 0 at its start; the frontends' walks for the kernel table
    import tempfile

    t_import = time.perf_counter()
    frontend_walks = {}
    with tempfile.TemporaryDirectory(prefix="ff_import_") as tmp:
        reset_launch_counts()
        line, onnx_paths, onnx_inputs, walk = phase_onnx(torch, tmp)
        zoo_paths["onnx"] = {k: n for k, n in launch_counts().items()
                             if n and "/" not in k}
        frontend_walks["onnx-b-predict"] = {k: n for k, n in walk.items()
                                            if "/" not in k}
        reset_launch_counts()
        line, walk, step = phase_fx(torch, tmp)
        zoo_paths["fx"] = {k: n for k, n in launch_counts().items()
                           if n and "/" not in k}
        frontend_walks["fx-predict-bf16"] = walk
        frontend_walks["fx-fit-step"] = step
        reset_launch_counts()
        line, spec, ckpt, cspec_x, trained, walk = phase_cspec(torch, tmp)
        zoo_paths["cspec"] = {k: n for k, n in launch_counts().items()
                              if n and "/" not in k}
        frontend_walks["cspec-predict"] = walk
        line, launches_62, walk = phase_repository(
            torch, lm, tmp, onnx_paths, onnx_inputs, spec, ckpt, cspec_x,
            trained)
        serving_paths["repository"] = {k: n for k, n in launches_62.items()
                                       if "/" not in k}
        frontend_walks["repository-fleet-spec-iter"] = walk
    print(f"phases 59-62: {time.perf_counter() - t_import:.1f} s, "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)

    # 63) keras: the Keras frontend's example models and keras_exp;
    # 64) elastic-dead-peer: a rank exits mid all-reduce. Launches: the
    # phase's runs, counted from 0 at its start; one fit step and one
    # predict walk of each example model for the kernel table
    t_keras = time.perf_counter()
    reset_launch_counts()
    line, keras_walks = phase_keras(torch)
    zoo_paths["keras"] = {k: n for k, n in launch_counts().items()
                          if n and "/" not in k}
    print(f"phase 63: {time.perf_counter() - t_keras:.1f} s", flush=True)
    t_dead = time.perf_counter()
    phase_elastic_dead_peer(torch)
    print(f"phase 64: {time.perf_counter() - t_dead:.1f} s; phases 63-64: "
          f"{time.perf_counter() - t_keras:.1f} s, "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)

    # 65) cli: the command line in this process. Launches: serve-bench's
    # run, counted from 0 at its start, and profile's fit
    t_cli = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ff_cli_") as tmp:
        line, cli_paths = phase_cli(torch, tmp)
    serving_paths["cli-serve-bench"] = cli_paths["cli-serve-bench"]
    zoo_paths["cli-profile-fit"] = cli_paths["cli-profile-fit"]
    print(f"phase 65: {time.perf_counter() - t_cli:.1f} s, "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)

    # the kernel table, the card, the result. A kernel's launches are
    # those of the path(s) that run it (serve, train, tier, standalone, tp
    # and search on rank 0, train-graph's graphed fit, mlp's eager fit, the serving
    # phases 16-20, the zoo's eager fits, predict's first call of each
    # model and the manual loop's two iterations), each counted from 0
    # just before its path ran; the server's and the fold's bucket
    # graphs: their warm-up and capture walks (a replay counts nothing)
    src = "flexflow_tpu_torch/csrc/"
    replaces = {
        "decode_attention": "flexflow_tpu/kernels/pallas/decode.py:130",
        "multiquery_decode_attention":
            "flexflow_tpu/kernels/pallas/decode.py:130",
        "layernorm_fwd": "flexflow_tpu/kernels/pallas/norm.py:98",
        "softmax_fwd": "flexflow_tpu/kernels/pallas/norm.py:369",
        "flash_fwd": "flexflow_tpu/kernels/flash_attention.py:256",
        "flash_bwd": "flexflow_tpu/kernels/flash_attention.py:412",
        "layernorm_bwd": "flexflow_tpu/kernels/pallas/norm.py:130",
        "softmax_bwd": "flexflow_tpu/kernels/pallas/norm.py:369",
        "rmsnorm_fwd": "flexflow_tpu/kernels/pallas/norm.py:251",
        "rmsnorm_bwd": "flexflow_tpu/kernels/pallas/norm.py:274",
        "reduce": "flexflow_tpu/kernels/pallas/reduction.py:52",
        "flash_fwd_blhd": "flexflow_tpu/kernels/flash_attention.py:110",
        "flash_bwd_blhd": "flexflow_tpu/kernels/flash_attention.py:613",
        "flash_fwd_bhld": "flexflow_tpu/kernels/flash_attention.py:110",
        "flash_bwd_bhld": "flexflow_tpu/kernels/flash_attention.py:613",
        "cumsum": "flexflow_tpu/kernels/pallas/reduction.py:127",
        # no Pallas kernel: the JAX update, which XLA fuses
        "optimizer_adam": "flexflow_tpu/runtime/optimizers.py:110",
        "optimizer_sgd": "flexflow_tpu/runtime/optimizers.py:53",
    }
    # the flash rows: timed in bf16, the tensor-core kernels; their f32
    # route runs the CUDA-core kernels of flash_attention.cu
    flash_tc = src + "flash_attention_tc.cu"
    sources = {"decode_attention": src + "decode_attention.cu",
               "multiquery_decode_attention": src + "decode_attention.cu",
               "flash_fwd": flash_tc, "flash_bwd": flash_tc,
               "reduce": src + "reduction.cu",
               "flash_fwd_blhd": flash_tc, "flash_bwd_blhd": flash_tc,
               "flash_fwd_bhld": flash_tc, "flash_bwd_bhld": flash_tc,
               "cumsum": src + "reduction.cu",
               "optimizer_adam": src + "optimizer.cu",
               "optimizer_sgd": src + "optimizer.cu"}
    kernels = []
    for name in replaces:
        by_path = {}
        if name in SERVE_KERNELS:
            # the timed serve run replays graphs, which run no wrapper:
            # serve-graph's profiler shows a replay's kernels
            by_path["serve_warmup_and_capture"] = launches[name]
        if name in TRAIN_KERNELS:
            by_path["train"] = train["launches"][name]
        if name in TIER_KERNELS:
            by_path["tier"] = tier["card_pallas_bf16"]["launches"][name]
        if name in STANDALONE_KERNELS:
            by_path["standalone"] = standalone["launches"][name]
        if name in TP_KERNELS or name == "optimizer_adam":
            by_path["tp"] = tp_launches[name]
        if name in TRAIN_PER_STEP:
            by_path["train-graph"] = train_graph["graph"]["launches"][name]
        if name in MLP_PER_STEP:
            by_path["mlp"] = mlp["eager"]["launches"][name]
        for path, counts in serving_paths.items():
            if name in counts:
                by_path[path] = counts[name]
        for path, counts in zoo_paths.items():
            if counts.get(name):
                by_path[path] = counts[name]
        row = dict(
            name=name, route="cuda", source=sources.get(name, src + "norm.cu"),
            replaces=replaces[name], launches=sum(by_path.values()),
            launches_by_path=by_path,
            # one fleet replica's launches a decode iteration, a prefill
            # chunk and a one-shot prefill (phases 55 and 58)
            fleet_per_walk={w: n.get(name, 0)
                            for w, n in sorted(fleet_walks.items())},
            # an fx predict walk (bf16) and fit step, an ONNX (b) and a
            # C-spec predict walk, a repository fleet replica's decode
            # iteration: speculative, 3 draft steps and the verify
            # (phases 59-62)
            frontends_per_walk={w: frontend_walks[w].get(name, 0)
                                for w in FRONTEND_WALKS},
            # a keras fit step and predict walk of seq_mnist_mlp's and
            # func_cifar10_cnn's models, bf16 (phase 63)
            keras_per_walk={w: keras_walks[w].get(name, 0)
                            for w in KERAS_WALKS},
            **table[name])
        if name.startswith("flash_"):
            row["f32_source"] = src + "flash_attention.cu"
        kernels.append(row)
    _emit({"kernels": kernels})
    print(_card_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
