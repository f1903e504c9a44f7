#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases 3 to 5 run for each served model in turn (qwen2.5-3b, zamba2-2.7b,
olmoe-1b-7b, falcon-mamba-7b, qwen2-vl-7b, seamless-m4t-medium), each
model freed before the next is built; phase 6 then runs the paper's closed
control loop over full-width qwen2.5-3b replicas, phase 7 its offline
learning and deployment orchestration on the trace phase 6 recorded,
phase 8 the same loop over worker processes (the remote fleet), phase 9
trains (the train route, full-width qwen2.5-3b steps) and serves the
trained weights, phase 10 runs the cost model: the one-card dry-run
of six full-width cells and the queueing model the planner sizes against,
phase 11 the replica fabric: one replica over a device mesh, a
multi-process pod, and phase 6's loop over the sharded topology, phase 12
the model axis: split-K decode and expert-parallel MoE over meshes whose
shards all lie on the one card, phase 13 training over such meshes,
with padded heads and the elastic re-mesh restore, phase 14 training
the SSM, hybrid, VLM and encoder-decoder families over such a mesh, and
phase 15 the dry-run on the production mesh: the serve steps partitioned
under ``serve_rules``, lone positions of the (16, 16) and (2, 16, 16)
meshes, and the training peaks under remat, and phase 16 the same serve
partition and lone cells for the SSM, hybrid, VLM and encoder-decoder
families.
Each phase's wall time is printed.  Any failure exits non-zero and prints
no result line.

1. build    — compile the Hopper kernels from ``src/repro_torch/kernels/csrc``.
2. kernels  — hold each kernel against its plain PyTorch version on the
              card, in bf16 at the shapes qwen2.5-3b serving gives it (plus
              one h2o-danube shape), the sampler (K3) at every served
              model's vocabulary, the SSD scan (K7) in float32 at the
              shapes zamba2-2.7b's prefill gives it (timed at 64, 200 and
              2048 tokens), and time kernel, plain version and one library
              call doing the same work; then the attention kernels again
              at zamba2's shared-attention shapes (32 heads, G = 1, hd 80),
              olmoe-1b-7b's (16 heads, G = 1, hd 128), qwen2-vl-7b's (28
              heads over 4 KV heads, G = 7, hd 128, max_seq 2048, K4 at
              1224 tokens) and seamless-m4t-medium's (16 heads, G = 1, hd
              64).  Tolerances:
              decode, paged decode and flash attention atol = rtol = 2e-2
              (bf16 outputs; the plain version rounds its probabilities to
              bf16, the kernels keep them in f32); the paged decode equal
              to the dense one bitwise under an identity table; the
              ring-slot and paged writes and greedy sampling exact; the
              sampler's hash bits bitwise and its noise within 1e-6; the
              SSD scan (y and final state) atol = rtol = 3e-4, the
              reference's own (chunked and sequential sums round
              differently); two identical calls of K1, K5, K3 and K7
              bitwise equal.  The write instances of K1 and K5 (what
              decode runs: the row's K/V write folded into the attention's
              launch), at all three attention shapes, with the written key
              in the first and in the last split, indices below Smax,
              wrapped and mixed, bf16 and float32 new rows: output and
              caches bitwise equal to K2, K2, K1 (K6, K6, K5), caches equal
              to the plain composition and the output within 2e-2 of it;
              timed beside K1 (K5) alone and the unfused three, at all
              five attention shapes.  Then the closed loop's shapes
              (``LoopConfig()``: 4 slots, max_seq 48, a first prefill
              chunk of 8): K4 at (1,8,16,128) over 2 KV heads, the write
              instances of K1 and K5 over a max_seq-48 cache with 4 rows
              (bitwise against K2, K2, K1 and K6, K6, K5), K3 at
              (4, 151936).  Last, K4 and K7 have no backward: with grad
              enabled and an input that requires it each raises
              ``NoBackwardError`` and launches nothing, and under
              ``torch.no_grad`` the same call launches.  Then phase 10's
              lengths: K4 at qwen2.5-3b's and h2o-danube-1.8b's shapes
              (window 4096) and K7 at zamba2's, held against their plain
              versions at 8192 tokens (atol = rtol as above) and timed
              there and at 2 x 32768 tokens (where the plain versions do
              not fit: not measured); K1's write instance over a
              32768-slot ring at qwen's and zamba2's shapes, every index
              regime and every row at 32767, bitwise against K2, K2, K1.
3. serve    — each model at full width and depth (olmoe-1b-7b at 4 of its
              16 layers and falcon-mamba-7b at 16 of its 64, ``DEPTH_CUT``,
              to pay for phase 10), random weights from a
              seed, on paths that each have the launch counts set to 0 just
              before and read just after: ``repro_torch.launch.serve.main``
              on the dense pool, prefill unchunked and chunked by 64; and
              ``ServingEngine(pool="paged", spec_k=3)``.  qwen2.5-3b and
              olmoe-1b-7b run it on prompts that share a 136-token prefix,
              with prefix sharing and speculative verify on; zamba2-2.7b
              pages its shared blocks' K/V and falcon-mamba-7b has nothing
              to page, and both serve plain (recurrent state cannot
              rewind).  olmoe's CLI runs at the published capacity factor
              1.25; its paged run on a dropless copy (capacity_factor =
              E/K) and then at 1.25.  qwen2-vl-7b's CLI serves 1224-token
              prompts (1024 patch positions, 200 text tokens) at max_seq
              2048, its --prefill-chunk 64 raised to 1025; its paged run
              puts 1024 shared patch positions before the shared prefix.
              seamless-m4t-medium is driven through ``ServingEngine`` (the
              CLI makes no frames, as in the reference): 8 requests of 200
              decoder tokens over frames of distinct encoder lengths in
              128..1024, dense unchunked and chunked by 64 and paged with
              spec_k=3 (served plain).  Every request must finish, greedy
              ticks must move no logits, the paged runs of the decoder
              models must hit the prefix registry, verify windows and
              accept drafts (qwen2-vl-7b's random-weight streams repeat no
              token, so its drafts are proposed and verified and the
              accepted count printed), the recurrent ones and seamless
              propose none, and every kernel's launch count
              must match the ticks, verify lanes and prefilled admissions
              of the run: decode runs the write instances only, each
              carrying the layer's two row writes, and the standalone K1,
              K2, K5 and K6 launch 0 times; seamless's K4 runs 12 times an
              admission, so none ran in the encoder.
4. streams  — full width: the paged (+ speculative) greedy streams equal
              the dense plain engine's, request for request, for qwen,
              zamba2, falcon, dropless olmoe, qwen2-vl and seamless (at
              1.25 olmoe's are printed, not held, beside the drop fraction
              of one-shot forwards).
              Smoke configs in float32: greedy streams through the kernels
              equal those of the plain versions (the same engine on the
              CPU, same weights), on the dense and the paged engine.
5. profile  — host time of a full-width decode tick (and of a qwen verify
              tick) beside the byte floor of the weights it reads, and the
              device time per kernel over steady-state ticks
              (torch.profiler; device busy is the sum over the device's
              own events, printed beside the sum over host ops and kernels
              alike, which counts a kernel launched by an aten op twice);
              then one profiled admission per model (200 tokens; 1224 for
              qwen2-vl; seamless's with its encoder frames), the named
              kernels' shares (K4, K7) beside the rest.  olmoe's MoE
              layers, falcon's selective scans and seamless's encoder and
              cross attention are timed as ranges of their own; falcon's
              scan loops also by the host clock in an unprofiled
              admission.
6. loop     — ``run_closed_loop`` (``LoopConfig()``, 12 ticks, ``--seed``,
              autoscale, planner mode: router, collector, anomaly
              detector, eviction policy, predictive allocator with its DQN)
              over full-width qwen2.5-3b replicas sharing one EngineCore,
              every tick printed as ``examples/serve_autoscale.py`` prints
              it; the replica trajectory must change.  Again with
              ``pool="paged", spec_k=3``: every request the dense run
              finished is finished by the paged run too (or still in
              flight when it ends), and one both finished has one greedy
              stream.  Each run's launch counts must equal,
              summed over every engine the router built (parked and retired
              ones too), 36 K4 an admission that prefilled, 36 K1 (K5)
              write instances a fused tick (a fused tick or verify lane),
              one K3 a fused tick, and 0 standalone K1, K2, K5, K6.  The
              host clock per router step and per control tick (the loop's
              work outside the router steps), device busy over the first
              LOOP_PROFILED_STEPS router steps of one profiled tick, peak
              memory.  The card's TickLogs
              (every field but ``learn_loss``) must equal the same loop's
              on the CPU at smoke width with qwen's vocabulary: no decision
              reads a token's value.  Last, the allocator's DQN on the card
              against the CPU at one set of bridged weights: q-values on the
              loop's recorded states, 10 ``train_offline`` steps over 256
              transitions from ``--seed``: losses, parameters and
              BatchNorm state within 1e-4 (two pre-BatchNorm biases, whose
              gradient is rounding noise, within AdamW's step bound); the
              times of ``q_values`` and a train step on each.
7. learning — phase 6's dense planner run and its CPU smoke run record
              their traces (``TraceRecorder``): equal, field for field (no
              field reads the host clock).  One set of DNN weights from
              ``--seed`` goes into the allocator of a hybrid loop on each
              device (``LoopConfig()`` with ``alloc_mode="hybrid"``, 14
              ticks: full-width qwen2.5-3b replicas on the card, its launch
              counts checked and added to the kernels line as phase 6's
              are; the smoke config at qwen's vocabulary on the CPU, given
              the full-width deployment vector), whose ``prime_allocator``
              runs ``pretrain_on_trace`` at the reference's defaults (20
              epochs, 60 DQN steps, 30 imitation epochs), each phase
              timed.  A trace carries one deployment vector, so the
              deployment stream's BatchNorms see identical rows and its
              leaves get rounding noise for gradient, which AdamW turns
              into steps of up to 1.2 lr and bn2's ReLU carries into the
              trunk: card and CPU part there.  So the pair is run twice:
              as the path runs (the schedule and draws equal, the first
              loss within 1e-4, the noise-driven elements within AdamW's
              bound, the other gaps printed) and with
              ``exact_deploy_stream`` from ``tests/test_torch_checks.py``
              (identical rows computed exactly), again full width on the
              card against smoke width on the CPU: every loss, parameter
              and BatchNorm statistic within 1e-4.  The exact pair's
              TickLogs must be equal up to the first tick whose decision
              margin (the top two Q-values among the actions the SLO
              envelope admits) is under 10x the card/CPU Q gap on the
              trace's states at the pretrained weights, that tick must
              come after tick 0, and learn_loss must stay within 1e-4 of
              its size (at least 1) while equal.  As the path runs the
              gap is the noise's (Q-values apart by tens), the rule holds
              no tick, and the comparison is only printed.  The
              DQN-decided ticks are counted.  Then, on the card-pretrained
              weights, on both devices: each feature group's raw increase
              of the evaluation loss, permuted as
              ``permutation_importance`` permutes it, on the trace's
              dataset (within 1e-4) and ``DNNSelector`` (``min_trained=
              1``) over each recorded tick's operating point (logits
              within 1e-4 of their size, at least 1; choices equal);
              last, ``RolloutManager`` for the
              chosen strategy, its ``DeployEnv`` carrying qwen2.5-3b's bf16
              bytes and a measured host -> card copy rate, fed the hybrid
              run's latencies against the planner run's: the phases and
              ``elapsed_s`` equal the CPU choice's.
8. fleet    — phase 6's dense loop (``LoopConfig()``, 12 ticks, ``--seed``,
              planner mode, 1 → 3 → 4 → 1 replicas) over worker
              processes, each serving full-width qwen2.5-3b on the card
              through the kernels: at ``topology="proc"`` (each replica a
              ``python -m repro_torch.serving.worker <fd> --device cuda``
              child) and at ``topology="tcp"`` over ``launch_fleet(4,
              device="cuda")`` with a read-only ``MetricsObserver`` on
              worker 0 (``observe_addrs``).  Each run's TickLogs'
              (replicas, reason, served) and every finished stream equal
              phase 6's in-process run of this chip run, bitwise; the
              workers' kernel launch counts (each writes its own, through
              ``REPRO_TORCH_WORKER_LAUNCHES``), summed, equal phase 6's,
              and the router's process launches none; at the first tick of
              4 replicas nvidia-smi lists 4 distinct worker PIDs, none this
              process's, each with its device memory; the observer's
              lifetime counters equal replica 0's through the router;
              ``off_list_spawns`` is 0; no worker outlives its run (all are
              killed in a ``finally``), and the workers load the kernel
              library phase 1 built.  Printed: the host clock per router
              step beside phase 6's, ``transport_ms``, each worker's start
              and ``init`` time; on a failure the workers' exit codes and
              stderr tail.
9. train    — the train route (``LM.forward(..., train=True)``, through
              ``models.steps``): no kernel runs on it, since the kernels have
              no backward and the reference trains with ``use_pallas`` off.
              (1) Every tiny family of ``tests/conftest.py`` (dense, swa,
              vlm, moe dropless, ssm1, ssm2, hybrid, audio; rebuilt here
              without JAX), float32, TF32 off: one seeded CPU model and its
              copy on the card, the counted pipeline's batches: one step's
              loss and every gradient leaf within 1e-4 (of the leaf's
              largest magnitude), 4 AdamW steps' losses within 1e-4
              relative; ``_sdpa_chunked`` and chunked CE at chunk 16 over
              64 tokens against the unchunked forms, values and gradients
              within 1e-5 (CE 1e-6); ``ops.launch_counts()`` unchanged and
              no ``NoBackwardError``.  (2) ``launch.train.main`` at smoke
              width on the card: 6 steps with ``--ckpt-every 3``, then
              ``--resume`` to 9, against an uninterrupted 9-step run: step
              9's metrics and every leaf of step 9's checkpoint within 1e-6
              relative, printed whether bitwise.  (3) Full width: the
              launcher trains qwen2.5-3b (36 layers, 3.09 B float32 masters,
              bf16 compute) 4 steps of 2 x 256 tokens, no checkpoint: every
              logged metric finite, no kernel launched; printed: the peak
              device memory, the host clock per step after the first and
              training tokens per second.  It runs twice: at the launcher's default
              lr 3e-4, whose records are printed (constant and without
              warmup, it overshoots at this depth: the loss swings by
              nats from step to step), and at lr 3e-5, whose last loss
              must be below its first.  One more step of the latter is
              profiled: device busy of the forward and backward alone and
              of the whole step, and the top device ops.  (4) The
              optimizer state freed, the model
              recast and served: 4 requests of 16 tokens through
              ``ServingEngine``, launch counts as phase 3's rules say (36 K4
              an admission, 36 K1 write instances and one K3 a fused tick),
              added to the kernels line; the streams equal those of a fresh
              model loaded with the trained parameters.  The phase prints
              its wall time.
10. cost    — ``repro_torch.launch.dryrun.analyze_cell`` at full width
              and depth, weights in bf16, on one card's share of the
              reference's cells (8 rows over a 32768-token ring for
              decode_32k, every row's index at 32767, danube's ring its
              4096 window; 2 prompts of 32768 for prefill_32k) for
              h2o-danube-1.8b, qwen2.5-3b and zamba2-2.7b: each cell's
              counted FLOPs, bytes and transcendentals, its step timed
              twice by CUDA events, launches a step and in all held to
              phase 3's rules (36 K1 write instances a qwen decode step,
              54 K7 and 9 K4 a zamba2 prefill) and added to the kernels
              line, and every kernel region equal to the kernel's
              ``cost(...)`` at the cell's shapes.  At smoke width the
              card's counts equal the CPU's exactly for the same program.
              Then ``RooflineDB`` over the six cells (each read as
              measured), the roofline and measured step times side by
              side, ``ServiceProfile.from_db``, ``examples/quickstart.py``'s
              part 3 on danube's profile (a planner-mode
              ``PredictiveAllocator`` at 20, 40, 80 and 160 rps), 10
              ``ServingModel.tick``s and ``ReplicaProfile.from_service``
              for zamba2 against qwen.
11. fabric  — (a) ``ShardedReplica`` on full-width qwen2.5-3b over a
              2-shard mesh on cuda:0 (``make_mesh`` naming the card
              twice), 8 slots, dense then paged, on phase 3's requests,
              stepped side by side with the unsharded
              ``InProcessReplica`` on the same core (its bulk path, whose
              streams must equal its fused ticks') and held tick by tick
              on the rows still in step: the first tick's logits within
              1e-4, every tick's within 0.25, every slot's K/V cache
              bitwise equal until a row's greedy choice first parts, and
              at most one request parting (where, the layer the caches
              part in, and the margin are printed); the write instances
              of K1 (K5) launch exactly 2 x 36 a decode tick, K4 36 an
              admission, K3 never (the sharded tick pulls the logits),
              and the replica adds less than half the weights' bytes (no
              copy on one card); ``logits_pulls`` and the host clock a
              step beside the
              unsharded replica's are printed.  (b) A 2-rank
              ``DistributedPodReplica``: two ``--device cuda`` worker
              processes over a gloo group, each a full-width qwen2.5-3b
              in mirror mode, on the same requests: streams equal (a)'s,
              a ``MetricsObserver`` on the head agrees with the stub's
              ``lifetime()`` at every poll, the head's info says rank 0,
              size 2, process count 2, mode mirror, and it compared one
              digest round a step; each rank's launch counts and peak
              device memory (``REPRO_TORCH_WORKER_STATS``) are held and
              printed.  (c) Phase 6's ``LoopConfig()`` over
              ``topology="sharded"`` (one shard a replica on one card):
              every TickLog field but learn_loss and every stream equal
              phase 6's; launch counts of the bulk path.  (a) and (c)
              join the kernels line.
12. axis    — the model axis through the serve partition (an ``LM``
              given to ``steps.make_decode_step`` under ``shard_ctx(...)``
              is laid out once as views and runs it).  The split-K body
              alone at qwen2.5-3b's decode shapes over a 4096-slot ring on
              4 shards (``Attention._decode_splitk`` with the mesh given:
              float32 within 1e-4 of ``sdpa_ref``, bf16 within 2e-2 of
              K1's write instance, the written caches bitwise equal; not
              counted).  Then, counted: (a) full-width qwen2.5-3b (36
              layers, bf16 weights): 8 prompts of 200 tokens prefilled
              through K4 into a 4096-slot ring, 8 greedy steps (K3 picks
              every token) on one device (K1's write instance) and under
              ``shard_ctx(SERVE_RULES, mesh)`` on a (1, 4) mesh on cuda:0
              (the sequence over "model": the split-K body, counted, runs
              in every layer; no decode kernel launches).  Step 1's
              written K/V rows are the body's new rows bitwise in every
              layer, layer 0's equal the one-device write, no other slot
              changes, the cache comes back split.  Fed the one-device
              run's tokens, every row's logits stay within AXIS_GAP of
              K1's at every step and the greedy choices part only at
              near-ties (top two within 2 x AXIS_GAP); free-running, the
              rows in step are held the same way and the parted ones
              printed.  A float32 copy at 4 layers, TF32 off: logits
              within 1e-4 x max(1, max |logit|) of the one-device steps.
              (b) One card's share of qwen2.5-3b decode_32k (8 rows over a
              32768-slot ring, index 32767) over a (1, 16) mesh on cuda:0
              beside the one-device step: CUDA-event times, peaks (the
              mesh within 1 GiB of one device's: the cache is never
              gathered), the collectives exactly the partition's
              (``partition_decode_records``: the embedding's and each
              layer's psums, wk/wv gathered whole, q over "model",
              split-K's pmax and psums, the logits' gathers) and their
              wire bytes, logits within AXIS_GAP.  (c) olmoe-1b-7b at full
              width and depth (64 experts, top 8): prefill 8 x 64 tokens
              and 4 steps on a (1, 4) mesh at capacity factor 1.25, every
              expert-parallel MoE call of the partition held against the
              global path on the same input (drop_frac and expert_load
              equal, y within 2e-2); then a dropless copy on a (2, 2)
              mesh held to the global run as (a)'s streams are.  (d)
              Full-width qwen2.5-3b on a (2, 2) mesh on cuda:0 under
              ``serve_rules(8)``, 8 rows at distinct positions (one
              ring wrapped), LAYOUT_STEPS steps in each cache layout the
              rules give: a 256-slot ring split over "model" (split-K with
              each row's index), a 4095-slot ring that 2 does not divide
              (the 2 KV heads split: K1's write instance on each rank's
              head) and the paged pool (16-slot blocks, a shuffled table
              with global ids: K5's write instance on each rank's head);
              the logits and the written K/V rows against one device's on
              the same weights, fed the same tokens, by FAMILY_BF16_NOTE's
              rule (the gap to a float32 witness within WITNESS_RATIO x
              one device's); K1's and K5's write-instance launches exactly
              positions x layers x steps; host clock and CUDA-event time a
              step beside one device's, wire bytes a device and their
              largest sources.  Launch counts join the kernels line.
13. mesh    — training over a ("data", "model") mesh under TRAIN_RULES,
              every position on cuda:0 (a collective is a copy within the
              card); the train route launches no kernel.  (a) qwen2.5-3b
              at full width and depth, float32 state, bf16 compute,
              through the launcher (``train(args, mesh_devices=...)``) on
              phase 9's batches (2 x 256 tokens, seed 0): 2 steps on one
              device, 2 on (2, 2), step 1's loss, ce and grad_norm within
              1e-2 relative; host clock a step and peak of each; one more
              mesh step under ``CostCounter``, its collectives (kind,
              group, count, result bytes; one data all-gather and one
              reduce-scatter a weight matrix held) and wire bytes a
              device; then a float32 copy at 4 layers, one step on each,
              metrics and every updated leaf (parameters, mu, nu) within
              1e-5 (leaves by max(1, max |leaf|)).  (b) Padded heads:
              qwen2.5-14b at full width, 2 of 48 layers (``PAD_LAYERS``),
              on (1, 16): 40 heads pad to 48, 3 a rank; 2 steps of 1 x
              256 tokens within 1e-2 of one device's on loss and
              grad_norm; the effective wo's pad rows exactly zero.  (c)
              Elastic: qwen2.5-3b at 4 layers, 4 steps on (2, 2), a
              checkpoint (bytes and write time printed),
              ``elastic_restore`` onto ``ReMesh(1, 4)`` (restore time
              printed) bitwise equal to the saved state, 2 more steps
              within 1e-2 of 2 more on (2, 2).  (d) olmoe-1b-7b at 4 of
              16 layers (``DEPTH_CUT``) on (2, 2), expert-parallel: a
              dropless copy within 1e-2 of one device's step; at capacity
              factor 1.25 the mesh's drop_frac (capacity per data shard)
              printed beside one device's.
14. families — phase 13's (2, 2) mesh for the families phase 13 leaves
              out, each at full width, float32 state, bf16 compute:
              falcon-mamba-7b at 2 of 64 layers (Mamba1, channel-parallel)
              and zamba2-2.7b at 12 of 54 Mamba2 layers with both shared
              blocks (two hybrid groups; Mamba2 head-parallel);
              qwen2-vl-7b at 4 of 28 layers, 2 x 1280 tokens of
              which 1024 are patch rows; seamless-m4t-medium at full
              depth, 2 x 256 tokens and frames (``FAMILY_CUTS``; the SSM
              families' tokens cut to 2 x 64: their scans are per-token
              loops).  Each: 2 steps on one device and on the
              mesh, step 1's loss, ce and grad_norm within 1e-2 relative;
              host clock a step and peak of each.  The two SSM families
              again with float32 compute, one step: metrics within 1e-5,
              leaves by phase 13's rule.  One mesh step under
              ``CostCounter`` (the SSM families' float32 step, the others'
              third bf16 step): its collectives and wire bytes a device,
              the "data" all-gathers and reduce-scatters held to the
              layout's count.
              zamba2's bf16 gradient is rounding-dominated (two valid
              roundings of the one-device step part by up to 2.8% on
              grad_norm), so its bf16 grad_norm is printed beside the
              float32 step's and held by the float32 copy
              (``BF16_NOISY_GRAD_NORM``).  Every block of a mesh state
              must lie on the card.
15. mesh dry-run — (a) the serve steps over weights laid out on a (2, 2)
              mesh on cuda:0 under ``serve_rules`` (``steps.serve_shardings``):
              full-width qwen2.5-3b, bf16, a prefill of 2 x 512 tokens into
              a 1024-slot ring and 2 decode steps of 8 rows fed the
              one-device run's tokens, logits and K/V caches within
              AXIS_GAP of the one-device steps' (each rank's partial
              products round to bf16 before the psum); a float32 copy at 4
              layers and olmoe-1b-7b at 4 layers (dropless, float32: bf16
              flips expert choices) within AXIS_F32_TOL x max(1, max
              |logit|), their caches AXIS_F32_TOL x max(1, max |K/V|).
              K4 one a layer on each position's heads, joining the kernels
              line; no decode kernel (split-K is plain ops).  The first and
              the last position alone (``LoneMesh``) record the same
              collectives as the full run, and a quarter of its kernel
              regions.  (b) Lone positions at full width and depth
              (``launch.dryrun.analyze_mesh_cell``): qwen2.5-3b decode_32k,
              prefill_32k (K4 36 a step, joining the kernels line) and
              train_4k (remat) on (16, 16), decode_32k on (2, 16, 16);
              qwen2-72b's and phi3.5-moe-42b-a6.6b's decode_32k on (16,
              16): per-device FLOPs, bytes, wire bytes, ``step_s`` (the
              position's compute), peak and the roofline terms
              ``RooflineDB`` reads with chips 256 or 512.  (c) The training
              peaks of phases 9 and 13 under remat "full"; one device's
              loss and gradients at 2 x 256, remat "none" and "full"
              (bitwise equal) and 2 x 1024, and "full" at 2 x 2048
              (where "none" runs out of memory).
16. families — phase 15 (a) and (b) for falcon-mamba-7b (8 of 64
              layers), zamba2-2.7b (12 of 54: two hybrid groups),
              qwen2-vl-7b (4 of 28 layers; 2 x 1224 tokens, 1024 of them
              patch rows, ring 2048) and seamless-m4t-medium (6 + 6 of
              12 + 12 layers; 2 x 512 frames and tokens): (a) on (2, 2)
              on cuda:0, bf16 beside one device, qwen2-vl's and
              seamless's logits and cache leaves within AXIS_GAP, the SSM families' against a float32 copy of
              the same weights (the witness: for the logits and every
              cache leaf, the mesh's gap to it within WITNESS_RATIO x one
              device's; FAMILY_BF16_NOTE), and a float32 copy at
              SERVE_F32_LAYERS layers (zamba2's in two hybrid groups, both
              shared blocks) within AXIS_F32_TOL x max(1, max |value|), each
              cache leaf at its own scale, its lone positions' collectives
              held to the full run's; K7 once a Mamba2 layer and K4 once
              a causal attention layer on each position.  (b)
              LONE_FAMILY_CELLS at full width and depth with their
              per-device counts, the largest sources of each cell's wire
              bytes (``collective_sizes``) and exact launches; falcon's
              and seamless's ``prefill_32k`` named as left out
              (LONE_LEFT_OUT).

Before the last line it prints one JSON object of per-kernel numbers and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_S = 989e12         # dense bf16 tensor-core rate
PEAK_F32_S = 67e12           # float32 outside the tensor cores
PEAK_TF32_S = 495e12         # dense TF32 tensor-core rate (3 per 3xTF32 product)
ATTN_TOL = 2e-2
SSM_TOL = 3e-4
NOISE_TOL = 1e-6
SPIN_CYCLES = 2_000_000      # ~1 ms at the H100's clock

# serving: qwen2.5-3b at full width, a few requests
SERVE = ["--arch", "qwen2.5-3b", "--device", "cuda", "--requests", "8",
         "--slots", "8", "--max-seq", "1024", "--prompt-len", "200",
         "--gen-len", "16", "--seed", "0"]
N_LAYERS = 36
SLOTS, MAX_SEQ = 8, 1024
# the paged + speculative run: 8 prompts of a shared 136-token prefix (17
# blocks of 8), a unique 24-token tail and, tiled twice, the 16 tokens a
# plain greedy run generated after prefix + tail (so drafts fire)
PREFIX_LEN, TAIL_LEN, GEN_LEN, SPEC_K = 136, 24, 16, 3
# zamba2-2.7b at full width: 54 Mamba2 layers (one K7 launch each per
# prefill) in 9 groups, each followed by a shared attention block (K4 at
# prefill, one K1 or K5 write instance per tick)
ZSERVE = ["--arch", "zamba2-2.7b", "--device", "cuda", "--requests", "8",
          "--slots", "8", "--max-seq", "1024", "--prompt-len", "200",
          "--gen-len", "16", "--seed", "0"]
Z_MAMBA, Z_ATTN = 54, 9
# the kernels of a zamba2 prefill, by a pattern of their CUDA names
ZAMBA2_KERNELS = (("K7", "ssd|ssm"), ("K4", "flash"))
# olmoe-1b-7b at full width: 16 layers of attention (16 heads, 16 KV heads,
# hd 128) and a 64-expert top-8 MoE; falcon-mamba-7b: 64 Mamba1 layers, no
# attention.  The CLI serves both as it serves qwen2.5-3b.
OSERVE = ["--arch", "olmoe-1b-7b"] + SERVE[2:]
# phases 3-5 run these two at a quarter of their depth (full width) to pay
# for phase 10; their full-depth numbers stand in PERF.md as history
DEPTH_CUT = {"olmoe-1b-7b": 4, "falcon-mamba-7b": 16}
FSERVE = ["--arch", "falcon-mamba-7b"] + SERVE[2:]
# qwen2-vl-7b at full width: 28 layers of 28 heads over 4 KV heads (G 7),
# hd 128, vocab 152064.  Every prompt opens with the 1024 patch positions
# (the engine feeds zero patches there), so the CLI's prompts are 1224
# tokens long and max_seq is 2048; --prefill-chunk 64 is raised to 1025
VL_PROMPT, VL_MAX_SEQ = 1224, 2048
VSERVE = ["--arch", "qwen2-vl-7b", "--device", "cuda", "--requests", "8",
          "--slots", "8", "--max-seq", str(VL_MAX_SEQ), "--prompt-len",
          str(VL_PROMPT), "--gen-len", "16", "--seed", "0"]
# seamless-m4t-medium at full width: 12 encoder and 12 decoder layers of 16
# heads of 64 (G 1), vocab 256206.  The CLI makes no frames, so it is
# driven through ServingEngine: 8 requests of a 200-token decoder prompt,
# 16 generated, over frames of distinct encoder lengths in 128..1024 drawn
# from ENC_SEED
ENC_SEED = 0

KERNEL_INFO = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:85"),
    "cache_ring_update": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                          "src/repro/kernels/decode_attention.py:236"),
    "fused_sample": ("src/repro_torch/kernels/csrc/sample.cu",
                     "src/repro/kernels/sample.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "decode_attention_paged": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:143"),
    "cache_paged_update": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                           "src/repro/kernels/decode_attention.py:196"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:68"),
    # K1 and K5 with K2's and K6's row writes (decode_attention.py:236 and
    # :196) folded into their launch
    "decode_attention_write": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:85"),
    "decode_attention_paged_write": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:143"),
}
# the standalone kernels that decode no longer launches
ROW_WRITES_ALONE = ("decode_attention", "cache_ring_update",
                    "decode_attention_paged", "cache_paged_update")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps=25, warmup=3) -> float:
    """Median device time of one call.  Each call follows an L2 flush (the
    serving path finds every layer's operands cold) and a ~1 ms device spin,
    so the host has queued the call before the device reaches it: the events
    time the device work, not the Python wrapper around it."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def ptxas_report(log: str,
                 pattern: str = r"flash|decode|sample|ssd|row_update"):
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in nvcc's ``-Xptxas -v`` output whose name matches ``pattern``,
    demangled where c++filt is at hand."""
    entries, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            entries.append((name, int(m.group(1)), *spills))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(entries):     # "void (anonymous namespace)::f<..>(..)"
        entries = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                    .split(" ", 1)[-1], *e[1:]) for n, e in zip(names, entries)]
    return [e for e in entries if re.search(pattern, e[0])]


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, tol, what) -> float:
    """max |got - want|; fails unless allclose at atol = rtol = tol."""
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: kernel vs plain max |err| {err}")
    return err


def ssd_inputs(torch, g, Bsz, L, H=80, hd=64, N=64):
    """K7's inputs as zamba2-2.7b's Mamba2 hands them over: float32, dt a
    softplus, A = -linspace(1, 16, H) (the init), one B/C group expanded
    over the heads (a view with a head stride of 0)."""
    dev = torch.device("cuda")
    x = torch.randn(Bsz, L, H, hd, generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(Bsz, L, H, generator=g,
                                                  device=dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, C = (torch.randn(Bsz, L, 1, N, generator=g, device=dev)
             .expand(Bsz, L, H, N) for _ in range(2))
    return x, dt, A, Bm, C


# the closed control loop, LoopConfig(): 4 slots, max_seq 48, a first
# prefill chunk of 8 tokens (16-token prompts, 8 generated), 12 ticks of 10
# router steps (the run's time limit: the workload spreads over the ticks,
# and at 12 the scaler still goes 1 -> 3 -> 4 -> 1, the last at tick 11;
# at 11 or fewer it never scales down); its write-instance checks write key 0 and key 47 in each
# regime; torch.profiler records the first router step of tick 5 (the
# spike): its trace is parsed on the host in proportion to its events
# (summing a whole tick of four replicas' took 47-57 s)
LOOP_TICKS, LOOP_SLOTS, LOOP_MAX_SEQ, LOOP_CHUNK = 12, 4, 48, 8
LOOP_WRITE_INDICES = {"fresh": [0, 17, 47, 9],
                      "wrapped": [48, 95, 101, 68],
                      "mixed": [0, 53, 47, 143]}
LOOP_PROFILED = (5, 5)
LOOP_PROFILED_STEPS = 1
# the allocator's DQN, card against CPU
DQN_TOL, DQN_STEPS, DQN_TRANSITIONS = 1e-4, 10, 256
SAMPLE_SHAPES = {"qwen2.5-3b": (8, 151936), "zamba2-2.7b": (8, 32000),
                 "olmoe-1b-7b": (8, 50304), "falcon-mamba-7b": (8, 65024),
                 "qwen2-vl-7b": (8, 152064),
                 "seamless-m4t-medium": (8, 256206),
                 "qwen2.5-3b loop": (LOOP_SLOTS, 151936)}
SSD_LENGTHS = (64, 200, 2048)
# phase 10's lengths: the prefill_32k and decode_32k cells; and the longest
# at which phase 2 holds K4 and K7 against their plain versions
DRY_LEN, LONG_LEN = 32768, 8192


def sample_rows(torch, ops, ref, sample_noise, g):
    """K3 at every served model's vocabulary (SAMPLE_SHAPES: 8 rows, and
    the closed loop's 4 at qwen2.5-3b's):
    greedy tokens bitwise equal to the plain version and to torch.argmax (a
    tie across a split boundary goes to the first index), hash bits
    bitwise, noise within 1e-6, the sampled token the Gumbel max; timed
    greedy beside the plain version and torch.argmax.  Returns qwen's row
    with the others under "others"."""
    from repro_torch.kernels import sample
    from repro_torch.kernels.sample import split_plan
    from repro_torch.kernels._lib import sm_count
    dev = torch.device("cuda")
    out = {}
    for arch, (B, V) in SAMPLE_SHAPES.items():
        split_len, n_splits = split_plan(B, V, sm_count(0))
        logits = torch.randn(B, V, generator=g, device=dev)
        k = split_len * (n_splits // 2)              # a split boundary
        logits[0, [k, k - 1, V - 3]] = logits[0].max() + 1.0
        seed = torch.arange(B, dtype=torch.int32, device=dev) * 7919 - 3
        rid = torch.arange(B, dtype=torch.int32, device=dev) + 100
        pos = torch.arange(B, dtype=torch.int32, device=dev) * 13
        greedy = torch.zeros(B, device=dev)
        got = ops.fused_sample(logits, seed, rid, pos, greedy)
        check(torch.equal(got, ref.fused_sample_ref(logits, seed, rid, pos,
                                                    greedy)),
              f"fused_sample (greedy, V {V}): kernel != plain")
        check(torch.equal(got, torch.argmax(logits, dim=1).to(torch.int32)),
              f"fused_sample (greedy, V {V}): kernel != torch.argmax")
        check(int(got[0]) == k - 1,
              f"fused_sample (V {V}): tie not broken to the first index")
        bits, noise = sample_noise(seed, rid, pos, V)
        want_bits = ref.sample_bits(seed.cpu(), rid.cpu(), pos.cpu(), V)
        check(torch.equal(bits.cpu(), want_bits), "sample hash bits differ")
        want_noise = ref.gumbel_noise(want_bits)
        check(torch.allclose(noise.cpu(), want_noise, rtol=NOISE_TOL,
                             atol=NOISE_TOL), "Gumbel noise differs")
        temp = torch.full((B,), 0.7, device=dev)
        got_t = ops.fused_sample(logits, seed, rid, pos, temp)
        check(torch.equal(got_t, ops.fused_sample(logits, seed, rid, pos,
                                                  temp)),
              "fused_sample (temperature): two identical calls differ")
        score = logits.float() / 0.7 + want_noise.to(dev)
        best = score.max(dim=1).values
        at_got = score.gather(1, got_t.long()[:, None])[:, 0]
        # equal token, or a near-tie that a last-ulp difference in g can flip
        check(bool(torch.all(at_got >= best - 1e-5 * best.abs())),
              "fused_sample (temperature): kernel token is not the Gumbel max")
        row = dict(
            max_abs_err=0.0,
            ms=timed_ms(torch, lambda: ops.fused_sample(logits, seed, rid,
                                                        pos, greedy)),
            plain_ms=timed_ms(torch, lambda: ref.fused_sample_ref(
                logits, seed, rid, pos, greedy)),
            library_ms=timed_ms(torch, lambda: torch.argmax(logits, dim=1)),
            shape=f"logits ({B},{V}) f32, greedy, {n_splits} splits of "
                  f"{split_len}")
        c = sample.cost(B, V)
        row["bound_ms"], row["bound_by"] = bound(c.bytes, c.flops,
                                                 PEAK_F32_S)
        out[arch] = row
    qwen = out.pop("qwen2.5-3b")
    qwen["others"] = out
    return qwen


def ssd_rows(torch, ops, ref, g):
    """K7 held against its plain version at (1, 200) and (2, 256), both y
    and the final state, two identical calls bitwise equal; then timed with
    the final state at (1, L) for L in SSD_LENGTHS.  Returns the (1, 200)
    row with the others under "others".  The bound: the larger of the
    bytes and the 3xTF32 products at the tensor cores' TF32 rate."""
    from repro_torch.kernels import ssm_scan
    errs = []
    for Bsz, L in ((1, 200), (2, 256)):
        args = ssd_inputs(torch, g, Bsz, L)
        y, h = ops.ssm_scan(*args, return_state=True)
        want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
        errs.append(max_err(torch, y, want_y, SSM_TOL,
                            f"ssm_scan y ({Bsz}, {L})"))
        errs.append(max_err(torch, h, want_h, SSM_TOL,
                            f"ssm_scan final state ({Bsz}, {L})"))
        check(torch.equal(ops.ssm_scan(*args), y),
              "ssm_scan: y differs without return_state")
        y2, h2 = ops.ssm_scan(*args, return_state=True)
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"ssm_scan ({Bsz}, {L}): two identical calls differ")
    rows = {}
    for L in SSD_LENGTHS:
        args = ssd_inputs(torch, g, 1, L)
        y, h = ops.ssm_scan(*args, return_state=True)
        want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
        err = max(max_err(torch, y, want_y, SSM_TOL, f"ssm_scan y (1, {L})"),
                  max_err(torch, h, want_h, SSM_TOL,
                          f"ssm_scan final state (1, {L})"))
        c = ssm_scan.cost(1, L, 80, 64, 64)
        row = dict(
            max_abs_err=max(errs + [err]),
            ms=timed_ms(torch, lambda: ops.ssm_scan(*args,
                                                    return_state=True)),
            plain_ms=timed_ms(torch, lambda: ref.ssm_scan_ref(
                *args, return_state=True), reps=5, warmup=1),
            library_ms=None,      # no PyTorch call computes an SSD scan
            shape=f"x (1,{L},80,64), dt (1,{L},80), B/C (1,{L},1,64) "
                  f"expanded to 80 heads, f32, with the final state")
        row["bound_ms"], row["bound_by"] = bound(c.bytes, 3 * c.flops,
                                                 PEAK_TF32_S)
        rows[L] = row
    main = rows.pop(200)
    main["others"] = {f"L={L}": r for L, r in rows.items()}
    return main


def write_indices(Smax):
    """Index rows of the write instances' checks, 8 rows each: every row
    below Smax, every row wrapped past it, and mixed.  Each regime writes
    key 0 (the first split) and key Smax - 1 (the last split)."""
    return {
        "fresh": [0, 5, 63, 64, 200, 511, Smax - 1, 77],
        "wrapped": [Smax, Smax + 63, 2 * Smax + 5, 3 * Smax - 1, Smax + 640,
                    4 * Smax + 1, 2 * Smax + 200, Smax + 77],
        "mixed": [0, Smax + 5, 200, 3 * Smax - 1, 640, Smax, 77,
                  2 * Smax + 300]}


def write_instance_row(torch, ops, ref, g, label, H, KV, hd, paged,
                       Smax=1024, B=8, indices=None, timed="mixed"):
    """K1's write instance (``decode_attention_write``), or K5's through a
    shuffled table over a pool of B · Smax / 8 + 1 blocks of 8 (``paged``),
    at (B, H, KV, hd), bf16 caches, index rows ``indices`` (default
    ``write_indices(Smax)``): in each index regime with bf16
    new rows, and mixed with float32 new rows, the output and both caches
    bitwise equal to the unfused kernels K2, K2, K1 (K6, K6, K5), the
    caches equal to the plain composition and the output within ATTN_TOL
    of it.  Timed in the ``timed`` regime: the write instance, K1 (K5)
    alone, the unfused three and the plain composition.  Bound: K1's (K5's) bytes and
    operations plus the new rows read and written into both caches.  No
    single PyTorch call writes and attends: library_ms is None."""
    from repro_torch.kernels import decode_attention
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    bk = 8
    nk = Smax // bk
    indices = indices or write_indices(Smax)
    randn = lambda *shape, dtype=bf16: torch.randn(
        *shape, generator=g, device=dev).to(dtype)
    q = randn(B, 1, H, hd)
    if paged:
        k0, v0 = randn(B * nk + 1, bk, KV, hd), randn(B * nk + 1, bk, KV, hd)
        tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
            B, nk).to(torch.int32)
    else:
        k0, v0 = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)

    def fused(kn, vn, kc, vc, idx):
        if paged:
            return ops.decode_attention_paged_write(q, kn, vn, kc, vc, tbl,
                                                    idx)
        return ops.decode_attention_write(q, kn, vn, kc, vc, idx)

    def alone(kc, vc, idx):
        if paged:
            return ops.decode_attention_paged(q, kc, vc, tbl, idx)
        return ops.decode_attention(q, kc, vc, idx)

    def unfused(kn, vn, kc, vc, idx):       # what decode ran before
        if paged:
            rpos = torch.remainder(idx, Smax)
            blk = tbl[torch.arange(B, device=dev), (rpos // bk).long()]
            ops.cache_paged_update(kc, kn, blk, rpos % bk)
            ops.cache_paged_update(vc, vn, blk, rpos % bk)
        else:
            slot = torch.remainder(idx, Smax)
            ops.cache_ring_update(kc, kn, slot)
            ops.cache_ring_update(vc, vn, slot)
        return alone(kc, vc, idx)

    def plain(kn, vn, kc, vc, idx):
        if paged:
            return ref.decode_attention_paged_write_ref(q, kn, vn, kc, vc,
                                                        tbl, idx)
        return ref.decode_attention_write_ref(q, kn, vn, kc, vc, idx)

    name = "decode_attention_paged_write" if paged else \
        "decode_attention_write"
    errs = []
    cases = [(r, bf16) for r in indices] + [("mixed", torch.float32)]
    for regime, new_dt in cases:
        idx = torch.tensor(indices[regime], dtype=torch.int32, device=dev)
        kn, vn = randn(B, KV, hd, dtype=new_dt), randn(B, KV, hd,
                                                       dtype=new_dt)
        what = f"{name} [{label}, {regime}, new {new_dt}]"
        kf, vf = k0.clone(), v0.clone()
        out = fused(kn, vn, kf, vf, idx)
        ku, vu = k0.clone(), v0.clone()
        check(torch.equal(out, unfused(kn, vn, ku, vu, idx)),
              f"{what}: output != the unfused kernels'")
        check(torch.equal(kf, ku) and torch.equal(vf, vu),
              f"{what}: caches != the unfused kernels'")
        kp_, vp_ = k0.clone(), v0.clone()
        want = plain(kn, vn, kp_, vp_, idx)
        check(torch.equal(kf, kp_) and torch.equal(vf, vp_),
              f"{what}: caches != the plain composition's")
        errs.append(max_err(torch, out, want, ATTN_TOL, what))
    idx = torch.tensor(indices[timed], dtype=torch.int32, device=dev)
    kn, vn = randn(B, KV, hd), randn(B, KV, hd)
    kc, vc = k0.clone(), v0.clone()
    live_b = torch.clamp(idx + 1, max=Smax)
    blocks = ((live_b + bk - 1) // bk).sum().item() if paged else 0
    c = decode_attention.cost(B, H, KV, hd, live_b.sum().item(),
                              blocks=blocks, new_itemsize=2)
    row = dict(
        max_abs_err=max(errs),
        ms=timed_ms(torch, lambda: fused(kn, vn, kc, vc, idx)),
        alone_ms=timed_ms(torch, lambda: alone(kc, vc, idx)),
        unfused_ms=timed_ms(torch, lambda: unfused(kn, vn, kc, vc, idx)),
        plain_ms=timed_ms(torch, lambda: plain(kn, vn, kc, vc, idx)),
        library_ms=None,
        shape=f"{label}: q ({B},1,{H},{hd}), "
              + (f"pool ({B * nk + 1},8,{KV},{hd}), shuffled table "
                 f"({B},{nk})" if paged else f"caches ({B},{Smax},{KV},{hd})")
              + f" bf16, new ({B},{KV},{hd}), index {timed}")
    row["bound_ms"], row["bound_by"] = bound(c.bytes, c.flops, PEAK_BF16_S)
    print(f"  {name} {row['shape']}: write instance {row['ms']:.4f} ms, "
          f"{'K5' if paged else 'K1'} alone {row['alone_ms']:.4f} ms, "
          f"unfused ({'K6, K6, K5' if paged else 'K2, K2, K1'}) "
          f"{row['unfused_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), max|err| "
          f"{row['max_abs_err']}; bitwise equal to the unfused kernels in "
          f"{len(cases)} cases")
    return row


# --------------------------------------------------------------------- phase 2


def kernel_phase(torch, ops, ref, sample_noise):
    from repro_torch.kernels import decode_attention, flash_attention
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def attn_err(got, want, what):
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=ATTN_TOL,
                            rtol=ATTN_TOL)
        check(ok, f"{what}: kernel vs plain max |err| {err}")
        return err

    def sdpa_ms(q, k, v, mask=None, causal=False):
        """One library call on the same inputs, as (B, H, S, hd) views."""
        return timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal, enable_gqa=True))

    # K2: ring-slot write, 8 slots, KV 2, hd 128, Smax 1024
    B, Smax, KV, hd = 8, 1024, 2, 128
    cache = randn(B, Smax, KV, hd)
    new = randn(B, KV, hd)
    slot = torch.tensor([0, 5, 200, 511, 1023, 0, 952, 77], dtype=torch.int32,
                        device=dev)
    want = ref.cache_ring_update_ref(cache.clone(), new, slot)
    got = ops.cache_ring_update(cache.clone(), new, slot)
    check(torch.equal(got, want), "cache_ring_update: kernel != plain")
    rows_idx = torch.arange(B, device=dev)
    slot_l = slot.long()

    def lib_k2():
        cache[rows_idx, slot_l] = new

    rows["cache_ring_update"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: ops.cache_ring_update(cache, new, slot)),
        plain_ms=timed_ms(torch, lambda: ref.cache_ring_update_ref(
            cache, new, slot)),
        library_ms=timed_ms(torch, lib_k2),
        shape="cache (8,1024,2,128) bf16, new (8,2,128)")
    c = decode_attention.row_write_cost(B, KV, hd)
    rows["cache_ring_update"]["bound_ms"], rows["cache_ring_update"][
        "bound_by"] = bound(c.bytes, c.flops, PEAK_BF16_S)

    # K1: decode attention; qwen2.5-3b (H 16, KV 2, hd 128, Smax 1024) and
    # h2o-danube (H 32, KV 8, hd 80, Smax = window 4096), mixed + wrapped
    errs, k1 = [], {}
    for name, (H, KV, hd, Smax) in {"qwen": (16, 2, 128, 1024),
                                    "danube": (32, 8, 80, 4096)}.items():
        q = randn(B, 1, H, hd)
        kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
        index = torch.tensor([0, 5, 200, Smax - 1, Smax, 3 * Smax + 7, 640,
                              77], dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, kc, vc, index)
        want = ref.decode_attention_ref(q, kc, vc, index)
        errs.append(attn_err(got, want, f"decode_attention[{name}]"))
        if name == "qwen":
            c = decode_attention.cost(
                B, H, KV, hd, torch.clamp(index + 1, max=Smax).sum().item())
            mask = (torch.arange(Smax, device=dev)[None, :]
                    <= index[:, None])[:, None, None, :]
            k1 = dict(
                ms=timed_ms(torch, lambda: ops.decode_attention(
                    q, kc, vc, index)),
                plain_ms=timed_ms(torch, lambda: ref.decode_attention_ref(
                    q, kc, vc, index)),
                library_ms=sdpa_ms(q, kc, vc, mask=mask),
                shape="q (8,1,16,128), caches (8,1024,2,128) bf16, index "
                      "mixed and wrapped")
            k1["bound_ms"], k1["bound_by"] = bound(c.bytes, c.flops,
                                                   PEAK_BF16_S)
    rows["decode_attention"] = dict(max_abs_err=max(errs), **k1)

    # K5: paged decode attention at the paged serve's shapes: q (8,1,16,128),
    # a pool of 8 * 128 + 1 blocks of 8 (block 0 the trash block), a
    # shuffled table, mixed and wrapped indices
    H, KV, hd, bk, nk = 16, 2, 128, 8, 128
    NB, Smax = B * nk + 1, nk * bk
    q = randn(B, 1, H, hd)
    kp, vp = randn(NB, bk, KV, hd), randn(NB, bk, KV, hd)
    tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
        B, nk).to(torch.int32)
    index = torch.tensor([0, 5, 200, Smax - 1, Smax, 3 * Smax + 7, 640, 77],
                         dtype=torch.int32, device=dev)
    got = ops.decode_attention_paged(q, kp, vp, tbl, index)
    want = ref.decode_attention_paged_ref(q, kp, vp, tbl, index)
    err = attn_err(got, want, "decode_attention_paged")
    # K5 == K1 bitwise under an identity table (same split plan and tiles)
    kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
    ident = torch.arange(B * nk, dtype=torch.int32, device=dev).reshape(B, nk)
    check(torch.equal(ops.decode_attention(q, kc, vc, index),
                      ops.decode_attention_paged(
                          q, kc.reshape(B * nk, bk, KV, hd),
                          vc.reshape(B * nk, bk, KV, hd), ident, index)),
          "decode_attention_paged != decode_attention under an identity "
          "table")
    # two identical calls give bitwise-equal outputs (no atomics)
    check(torch.equal(ops.decode_attention(q, kc, vc, index),
                      ops.decode_attention(q, kc, vc, index)),
          "decode_attention: two identical calls differ")
    check(torch.equal(ops.decode_attention_paged(q, kp, vp, tbl, index),
                      ops.decode_attention_paged(q, kp, vp, tbl, index)),
          "decode_attention_paged: two identical calls differ")
    live_b = torch.clamp(index + 1, max=Smax)
    # q in, out, the live K/V rows, the table entries they need, the index
    c = decode_attention.cost(B, H, KV, hd, live_b.sum().item(),
                              blocks=((live_b + bk - 1) // bk).sum().item())
    # yardstick: one library attention over a view gathered beforehand
    # (no single PyTorch call attends through a block table)
    kg = kp[tbl.long()].reshape(B, Smax, KV, hd)
    vg = vp[tbl.long()].reshape(B, Smax, KV, hd)
    mask = (torch.arange(Smax, device=dev)[None, :]
            <= index[:, None])[:, None, None, :]
    rows["decode_attention_paged"] = dict(
        max_abs_err=err,
        ms=timed_ms(torch, lambda: ops.decode_attention_paged(
            q, kp, vp, tbl, index)),
        plain_ms=timed_ms(torch, lambda: ref.decode_attention_paged_ref(
            q, kp, vp, tbl, index)),
        library_ms=sdpa_ms(q, kg, vg, mask=mask),
        shape="q (8,1,16,128), pool (1025,8,2,128) bf16, shuffled table "
              "(8,128), index mixed and wrapped; library = SDPA over a "
              "pre-gathered view")
    rows["decode_attention_paged"]["bound_ms"], rows[
        "decode_attention_paged"]["bound_by"] = bound(c.bytes, c.flops,
                                                      PEAK_BF16_S)

    # K6: paged write into that pool, distinct (blk, off) targets, exact in
    # f32 and bf16 (new rows in f32 and bf16)
    blk = torch.tensor([1, 1024, 7, 500, 33, 1, 900, 64], dtype=torch.int32,
                       device=dev)
    off = torch.tensor([0, 7, 3, 5, 1, 6, 2, 4], dtype=torch.int32,
                       device=dev)
    for dt in (torch.float32, bf16):
        for new_dt in (torch.float32, bf16):
            pool = randn(NB, bk, KV, hd, dtype=dt)
            new = randn(B, KV, hd, dtype=new_dt)
            want = ref.cache_paged_update_ref(pool.clone(), new, blk, off)
            ops.cache_paged_update(pool, new, blk, off)
            check(torch.equal(pool, want),
                  f"cache_paged_update {dt}/{new_dt}: kernel != plain")
    new = randn(B, KV, hd)
    blk_l, off_l = blk.long(), off.long()

    def lib_k6():
        kp[blk_l, off_l] = new

    rows["cache_paged_update"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: ops.cache_paged_update(kp, new, blk, off)),
        plain_ms=timed_ms(torch, lambda: ref.cache_paged_update_ref(
            kp, new, blk, off)),
        library_ms=timed_ms(torch, lib_k6),
        shape="pool (1025,8,2,128) bf16, new (8,2,128)")
    c = decode_attention.row_write_cost(B, KV, hd, paged=True)
    rows["cache_paged_update"]["bound_ms"], rows["cache_paged_update"][
        "bound_by"] = bound(c.bytes, c.flops, PEAK_BF16_S)

    # K4: flash attention (prefill); qwen2.5-3b at Sq 64 and a ragged 200,
    # h2o-danube (hd 80) with its 4096 window and with a short window 64,
    # and hd 8 and 16 (the smoke configs' widths: the tensor-core body pads
    # them to 16 in shared memory)
    errs, k4 = [], {}
    for name, (S, H, KV, hd, window) in {
            "qwen200": (200, 16, 2, 128, None), "qwen64": (64, 16, 2, 128, None),
            "danube": (200, 32, 8, 80, 4096),
            "danube_w64": (200, 32, 8, 80, 64),
            "hd8": (200, 16, 2, 8, None), "hd16": (37, 4, 2, 16, 16)}.items():
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        errs.append(attn_err(got, want, f"flash_attention[{name}]"))
        if name == "qwen200":
            c = flash_attention.cost(1, S, S, H, KV, hd)
            k4 = dict(
                ms=timed_ms(torch, lambda: ops.flash_attention(
                    q, k, v, causal=True)),
                plain_ms=timed_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=True)),
                library_ms=sdpa_ms(q, k, v, causal=True),
                shape="q (1,200,16,128), k/v (1,200,2,128) bf16, causal")
            k4["bound_ms"], k4["bound_by"] = bound(c.bytes, c.flops,
                                                   PEAK_BF16_S)
    rows["flash_attention"] = dict(max_abs_err=max(errs), **k4)

    # K3: fused sampling over qwen2.5-3b's 151,936-token vocabulary (the
    # kernels line) and zamba2-2.7b's 32,000
    rows["fused_sample"] = sample_rows(torch, ops, ref, sample_noise, g)

    # K7: the SSD scan at zamba2-2.7b's prefill (80 heads, hd 64, N 64): a
    # ragged 200-token prompt and an aligned batch of two of 256, y and the
    # final state (the prefill always asks for it); then timed at the
    # chunked prefill's one chunk (64), the unchunked prompt (200, the
    # kernels line) and a long prompt (2048)
    rows["ssm_scan"] = ssd_rows(torch, ops, ref, g)
    for name, r in rows.items():
        for label, rr in {"": r, **r.get("others", {})}.items():
            print(f"  {name}{' ' + label if label else ''}: {rr['shape']}: "
                  f"kernel {rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, "
                  f"library {rr['library_ms']} ms, bound "
                  f"{rr['bound_ms']:.5f} ms ({rr['bound_by']}), max|err| "
                  f"{rr['max_abs_err']}")
    # K1 and K5 with the row write folded in, at the qwen2.5-3b shapes above
    for paged in (False, True):
        row = write_instance_row(torch, ops, ref, g, "qwen2.5-3b", 16, 2, 128,
                                 paged)
        rows["decode_attention_paged_write" if paged
             else "decode_attention_write"] = row
    return rows


def windowed_sdpa_ms(torch, q, k, v, window):
    """One ``scaled_dot_product_attention`` call over a boolean causal
    sliding-window mask (key j visible to query i when i - window < j <=
    i), q (B, S, H, hd), k/v (B, S, KV, hd) → (ms, what ran).  Only the
    memory-efficient backend takes a mask without holding the scores (the
    math backend's float32 scores are B·H·S²·4 bytes, 275 GB at danube's 2
    x 32768), and it refuses grouped K/V (no kernel for
    ``enable_gqa``), so K/V are expanded to H heads before the timed
    call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    S, H = q.shape[1], q.shape[2]
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    G = H // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kt, vt = (x.repeat_interleave(G, dim=1) for x in (kt, vt))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=5, warmup=1)
    return ms, (f"memory-efficient SDPA, ({S}, {S}) boolean window mask "
                f"({mask.numel() / 2**30:.2f} GiB), K/V expanded {G}x to "
                f"{H} heads beforehand")


def long_rows(torch, ops, ref, seed=29):
    """The kernels at phase 10's lengths.  K4 (qwen2.5-3b's 16 heads over
    2, hd 128, causal; h2o-danube-1.8b's 32 over 8, hd 80, window 4096) and
    K7 (zamba2-2.7b's) held against their plain versions at LONG_LEN
    tokens and timed there beside them; timed again at the prefill_32k
    cell's call, 2 prompts of DRY_LEN, where the plain versions do not fit
    (K4's scores alone, S²·H·4 bytes, would be 137 GB for qwen) and are not
    measured.  K1's write instance over a DRY_LEN-slot ring at qwen2.5-3b's
    and zamba2-2.7b's shapes, every index regime of ``write_indices`` and
    the decode_32k cell's (every row at DRY_LEN - 1, the whole ring live),
    timed in the latter.  Library: SDPA (causal; danube's with a boolean
    window mask, ``windowed_sdpa_ms``)."""
    from repro_torch.kernels import flash_attention, ssm_scan
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g,
                                       device=dev).to(bf16)
    rows = {}

    def show(name, r):
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{fmt(r['plain_ms'])}, library {fmt(r['library_ms'])}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max|err| "
              f"{r['max_abs_err']}")
        rows[name] = r

    for label, (H, KV, hd, window) in {
            "qwen2.5-3b": (16, 2, 128, None),
            "h2o-danube-1.8b": (32, 8, 80, 4096)}.items():
        for Bq, S in ((1, LONG_LEN), (2, DRY_LEN)):
            q, k, v = randn(Bq, S, H, hd), randn(Bq, S, KV, hd), randn(
                Bq, S, KV, hd)
            kernel = lambda: ops.flash_attention(q, k, v, causal=True,
                                                 window=window)
            r = dict(max_abs_err=None, plain_ms=None, library_ms=None,
                     ms=timed_ms(torch, kernel, reps=5, warmup=1),
                     shape=f"q ({Bq},{S},{H},{hd}), k/v ({Bq},{S},{KV},"
                           f"{hd}) bf16, causal"
                           + (f", window {window}" if window else ""))
            if S == LONG_LEN:
                plain = lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                        window=window)
                r["max_abs_err"] = max_err(torch, kernel(), plain(), ATTN_TOL,
                                           f"flash_attention [{label}, {S}]")
                r["plain_ms"] = timed_ms(torch, plain, reps=3, warmup=1)
            if window is None:
                r["library_ms"] = timed_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True, enable_gqa=True),
                    reps=5, warmup=1)
            else:
                r["library_ms"], r["library_call"] = windowed_sdpa_ms(
                    torch, q, k, v, window)
                print(f"  library at {label} S={S}: {r['library_call']}")
            c = flash_attention.cost(Bq, S, S, H, KV, hd, window=window)
            r["bound_ms"], r["bound_by"] = bound(c.bytes, c.flops,
                                                 PEAK_BF16_S)
            show(f"flash_attention {label} S={S}", r)
            del q, k, v
    for Bsz, L in ((1, LONG_LEN), (2, DRY_LEN)):
        args = ssd_inputs(torch, g, Bsz, L)
        kernel = lambda: ops.ssm_scan(*args, return_state=True)
        r = dict(max_abs_err=None, plain_ms=None, library_ms=None,
                 ms=timed_ms(torch, kernel, reps=5, warmup=1),
                 shape=f"x ({Bsz},{L},80,64), dt ({Bsz},{L},80), B/C "
                       f"({Bsz},{L},1,64) expanded to 80 heads, f32, with "
                       f"the final state")
        if L == LONG_LEN:
            y, h = kernel()
            t0 = time.perf_counter()
            want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
            torch.cuda.synchronize()
            r["plain_ms"] = (time.perf_counter() - t0) * 1e3
            r["max_abs_err"] = max(
                max_err(torch, y, want_y, SSM_TOL, f"ssm_scan y (1, {L})"),
                max_err(torch, h, want_h, SSM_TOL,
                        f"ssm_scan final state (1, {L})"))
            del y, h, want_y, want_h
        c = ssm_scan.cost(Bsz, L, 80, 64, 64)
        r["bound_ms"], r["bound_by"] = bound(c.bytes, 3 * c.flops,
                                             PEAK_TF32_S)
        show(f"ssm_scan L={L}", r)
        del args
    for label, (H, KV, hd) in {"qwen2.5-3b": (16, 2, 128),
                               "zamba2-2.7b": (32, 32, 80)}.items():
        indices = {**write_indices(DRY_LEN), "full": [DRY_LEN - 1] * 8}
        rows[f"decode_attention_write {label} Smax={DRY_LEN}"] = \
            write_instance_row(torch, ops, ref, g, f"{label}, decode_32k",
                               H, KV, hd, False, Smax=DRY_LEN,
                               indices=indices, timed="full")
    free(torch)
    return rows


def attention_shapes_phase(torch, ops, ref, label, H, KV, hd, seed,
                           Smax=1024, S=200):
    """K1, K2, K4, K5 and K6 at another model's attention shapes, 8 slots:
    zamba2's shared attention (32 heads, 32 KV heads, hd 80), olmoe-1b-7b
    (16 heads, 16 KV heads, hd 128) and seamless-m4t-medium's decoder (16
    heads, 16 KV heads, hd 64), all G = 1, max_seq 1024, prompts of 200
    tokens; qwen2-vl-7b (28 heads over 4 KV heads, G = 7, hd 128), max_seq
    2048, prompts of 1224 tokens.  Decode rows sit near S tokens, K4 runs
    one S-token prompt.  In bf16: held against their plain versions and
    timed as in kernel_phase; then the write instances of K1 and K5 there.
    Printed; the kernels line keeps the qwen2.5-3b shapes."""
    from repro_torch.kernels import decode_attention, flash_attention
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    B, bk = 8, 8
    nk = Smax // bk
    randn = lambda *shape: torch.randn(*shape, generator=g,
                                       device=dev).to(bf16)
    index = S + 2 * torch.arange(B, dtype=torch.int32, device=dev)
    live = (index + 1).sum().item()
    mask = (torch.arange(Smax, device=dev)[None, :]
            <= index[:, None])[:, None, None, :]
    q = randn(B, 1, H, hd)
    kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
    NB = B * nk + 1
    kp, vp = randn(NB, bk, KV, hd), randn(NB, bk, KV, hd)
    tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
        B, nk).to(torch.int32)
    kg = kp[tbl.long()].reshape(B, Smax, KV, hd)
    vg = vp[tbl.long()].reshape(B, Smax, KV, hd)
    new = randn(B, KV, hd)
    rows_idx, slot_l = torch.arange(B, device=dev), index.long()
    blk = tbl[rows_idx, slot_l // bk]
    off = (index % bk).to(torch.int32)
    qs, ks, vs = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    blocks = ((index + bk) // bk).sum().item()
    sdpa = lambda q_, k_, v_, **kw: F.scaled_dot_product_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        enable_gqa=H != KV, **kw)

    def lib_k2():
        kc[rows_idx, slot_l] = new

    def lib_k6():
        kp[blk.long(), off.long()] = new

    cases = {
        "decode_attention": (
            lambda: ops.decode_attention(q, kc, vc, index),
            lambda: ref.decode_attention_ref(q, kc, vc, index),
            lambda: sdpa(q, kc, vc, attn_mask=mask),
            decode_attention.cost(B, H, KV, hd, live), False),
        "cache_ring_update": (
            lambda: ops.cache_ring_update(kc, new, index),
            lambda: ref.cache_ring_update_ref(kc, new, index), lib_k2,
            decode_attention.row_write_cost(B, KV, hd), True),
        "flash_attention": (
            lambda: ops.flash_attention(qs, ks, vs, causal=True),
            lambda: ref.flash_attention_ref(qs, ks, vs, causal=True),
            lambda: sdpa(qs, ks, vs, is_causal=True),
            flash_attention.cost(1, S, S, H, KV, hd), False),
        "decode_attention_paged": (
            lambda: ops.decode_attention_paged(q, kp, vp, tbl, index),
            lambda: ref.decode_attention_paged_ref(q, kp, vp, tbl, index),
            lambda: sdpa(q, kg, vg, attn_mask=mask),
            decode_attention.cost(B, H, KV, hd, live, blocks=blocks), False),
        "cache_paged_update": (
            lambda: ops.cache_paged_update(kp, new, blk, off),
            lambda: ref.cache_paged_update_ref(kp, new, blk, off), lib_k6,
            decode_attention.row_write_cost(B, KV, hd, paged=True), True),
    }
    for name, (kernel, plain, library, c, exact) in cases.items():
        if exact:    # the writes land in the caches: compare copies
            cache = kc if name == "cache_ring_update" else kp
            before = cache.clone()
            kernel()
            got = cache.clone()
            cache.copy_(before)
            plain()
            check(torch.equal(got, cache), f"{name} [{label}]: kernel != "
                                           f"plain")
            err = 0.0
        else:
            err = max_err(torch, kernel(), plain(), ATTN_TOL,
                          f"{name} [{label}]")
        b_ms, b_by = bound(c.bytes, c.flops, PEAK_BF16_S)
        where = f" (1,{S},{H},{hd})" if name == "flash_attention" else ""
        print(f"  {label} {name}{where}: kernel {timed_ms(torch, kernel):.4f} "
              f"ms, plain {timed_ms(torch, plain):.4f} ms, library "
              f"{timed_ms(torch, library):.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), max|err| {err}")
    for paged in (False, True):
        write_instance_row(torch, ops, ref, g, label, H, KV, hd, paged, Smax)


# --------------------------------------------------------------------- phase 3


def decoder_launches(n_layers):
    """A decoder model's launch counts (qwen2.5-3b's 36 layers,
    olmoe-1b-7b's 16): per layer one K1 write instance a dense tick (or one
    K5 write instance a paged lane), each carrying the layer's two row
    writes; one K4 per layer a prefilled admission, one K3 a fused tick.
    The standalone K1, K2, K5 and K6 launch 0 times."""
    def launches(ticks, prefilled, lanes=0, fused=None):
        return {"decode_attention": 0, "cache_ring_update": 0,
                "fused_sample": ticks if fused is None else fused,
                "flash_attention": n_layers * prefilled,
                "decode_attention_paged": 0, "cache_paged_update": 0,
                "ssm_scan": 0, "decode_attention_write": n_layers * ticks,
                "decode_attention_paged_write": n_layers * lanes}
    return launches


def zamba2_launches(ticks, prefilled, paged=False):
    """zamba2-2.7b's: one K7 per Mamba2 layer and one K4 per group a
    prefilled admission; per group one K1 write instance (or one K5 write
    instance paged) a tick, carrying two row writes; one K3 a tick (every
    tick is fused: no speculation).  The standalone K1, K2, K5 and K6
    launch 0 times."""
    dense_ticks, paged_ticks = (0, ticks) if paged else (ticks, 0)
    return {"decode_attention": 0, "cache_ring_update": 0,
            "fused_sample": ticks, "flash_attention": Z_ATTN * prefilled,
            "decode_attention_paged": 0, "cache_paged_update": 0,
            "ssm_scan": Z_MAMBA * prefilled,
            "decode_attention_write": Z_ATTN * dense_ticks,
            "decode_attention_paged_write": Z_ATTN * paged_ticks}


def mamba1_launches(ticks, prefilled):
    """falcon-mamba-7b's: one K3 a tick (every tick is fused: recurrent
    state cannot rewind, so nothing is speculated) and nothing else: the
    model has no attention, and Mamba1's scan is no kernel of the JAX
    package."""
    return {**{name: 0 for name in KERNEL_INFO}, "fused_sample": ticks}


def check_launches(counts, want, what):
    """The exact counts, and in so many words: no standalone row write (or
    unfused K1/K5) ran on a serving path; each write instance launch
    carried two row writes."""
    rows = 2 * (counts["decode_attention_write"]
                + counts["decode_attention_paged_write"])
    print(f"    launches {counts}; row writes carried in the write "
          f"instances: {rows}")
    check(all(counts[k] == 0 for k in ROW_WRITES_ALONE),
          f"{what}: a standalone row write or unfused decode ran: {counts}")
    check(counts == want, f"{what}: launch counts {counts}, expected {want}")


def serve_phase(torch, ops, serve, base_argv, expected):
    """The serve CLI at full width, unchunked and chunked by 64; launch
    counts must equal ``expected(ticks, admissions)``."""
    launches = {name: 0 for name in ops.KERNELS}
    for chunk in (None, 64):
        argv = base_argv + ([] if chunk is None else
                            ["--prefill-chunk", str(chunk)])
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print(f"  serve {' '.join(argv)}  ({wall:.1f} s with weight init, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        print("    " + text.strip().replace("\n", "\n    "))
        check(rc == 0, f"serve exited {rc}")
        m = re.search(r"ticks=(\d+) admissions=(\d+) logits_pulls=(\d+) "
                      r"finished=(\d+)", text)
        check(m is not None, "serve printed no tick summary")
        ticks, admissions, pulls, finished = map(int, m.groups())
        check(finished == 8, f"{finished}/8 requests finished")
        check(admissions == 8, f"{admissions} admissions for 8 requests")
        check(pulls == 0, f"greedy serving pulled logits {pulls} times")
        check_launches(counts, expected(ticks, admissions), "serve")
        for name in launches:
            launches[name] += counts[name]
        free(torch)
    return launches


def run_shared(eng, prompts):
    """Request 0 alone until it has streamed past the shared prefix (a
    VLM's patch positions and PREFIX_LEN tokens; its prefix blocks are then
    registered), then the other seven; run to the end and return the
    greedy streams by request id."""
    import numpy as np
    from repro_torch.serving import Request
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), gen_len=GEN_LEN)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0], now=0.0)
    done, step = [], 0
    while eng.pos[0] < eng.cfg.n_vision_patches + PREFIX_LEN:
        step += 1
        done.extend(eng.step(now=float(step)))
    for r in reqs[1:]:
        eng.submit(r, now=float(step))
    while len(done) < len(reqs):
        step += 1
        check(step < 5000, "the shared-prefix run did not finish")
        done.extend(eng.step(now=float(step)))
    return {r.rid: list(r.tokens_out) for r in done}


def shared_prompts(core):
    """Prefix + tail_i + Y_i + Y_i, Y_i the 16 tokens a plain greedy run
    generates after prefix + tail_i (drafts then find their n-grams).  A
    VLM's prompts open with the same patch positions (token ids drawn from
    a seed of their own; the patches replace their embeddings)."""
    import numpy as np
    from repro_torch.serving import Request, ServingEngine
    rng = np.random.default_rng(1)
    vocab = core.cfg.vocab
    prefix = rng.integers(3, vocab, PREFIX_LEN)
    prefix = np.concatenate([np.random.default_rng(4).integers(
        3, vocab, core.cfg.n_vision_patches), prefix])
    bases = [np.concatenate([prefix, rng.integers(3, vocab, TAIL_LEN)])
             .astype(np.int32) for _ in range(SLOTS)]
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core)
    reqs = [Request(rid=i, prompt=b, gen_len=GEN_LEN)
            for i, b in enumerate(bases)]
    for r in reqs:
        eng.submit(r, now=0.0)
    done = []
    while len(done) < len(reqs):
        done.extend(eng.step(now=0.0))
    ys = {r.rid: np.asarray(r.tokens_out, np.int32) for r in done}
    return [np.concatenate([b, ys[i], ys[i]]) for i, b in enumerate(bases)]


@contextlib.contextmanager
def counted_steps(core):
    """Count the engine's fused ticks and verify lanes (a verify tick of
    window W decodes W lanes) by wrapping its step functions."""
    calls = {"fused": 0, "verify": 0, "lanes": 0}
    fused, verify = core.fused_decode, core.verify

    def fused_counted(*args):
        calls["fused"] += 1
        return fused(*args)

    def verify_counted(params, tokens, cache):
        calls["verify"] += 1
        calls["lanes"] += tokens.shape[1]
        return verify(params, tokens, cache)

    core.fused_decode, core.verify = fused_counted, verify_counted
    try:
        yield calls
    finally:
        core.fused_decode, core.verify = fused, verify


def paged_serve_phase(torch, ops, core, prompts, hold_accepted=True):
    """ServingEngine(pool="paged", spec_k=3) at full width: prefix sharing
    and speculative verify on; K5's write instance carries every decoded
    lane, K1's none.  Drafts must be proposed, and accepted unless
    ``hold_accepted`` is False (then the count is printed)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.slots import pool_geometry
    bk = pool_geometry(SLOTS, core.max_seq)[0]
    check(bk == 8, f"default block size {bk}, expected 8")
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core, pool="paged", spec_k=SPEC_K,
                        prefill_chunk=bk)
    with counted_steps(core) as calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        streams = run_shared(eng, prompts)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    life = eng.lifetime()
    lanes = calls["fused"] + calls["lanes"]
    print(f"  paged + spec_k={SPEC_K}, bk {bk}, prefill_chunk "
          f"{eng.prefill_chunk}: "
          f"{life['total_tokens']} tokens in {wall:.2f} s "
          f"({life['total_tokens'] / wall:.1f} tok/s, host clock), "
          f"{life['total_ticks']} ticks = {calls['fused']} fused + "
          f"{calls['verify']} verify ({calls['lanes']} lanes)")
    print(f"    prefix_hits={life['prefix_hits']} prefix_admits="
          f"{life['prefix_admits']} tokens_shared={life['tokens_shared']} "
          f"prefill_tokens={life['prefill_tokens']} prompt_tokens="
          f"{life['prompt_tokens']} spec_proposed={life['spec_proposed']} "
          f"spec_accepted={life['spec_accepted']} logits_pulls="
          f"{life['logits_pulls']}")
    check(life["total_completed"] == SLOTS,
          f"{life['total_completed']}/{SLOTS} requests finished")
    check(life["prefix_hits"] > 0, "no admission hit the prefix registry")
    check(life["spec_proposed"] > 0, "no draft was proposed")
    check(calls["verify"] > 0, "no verify window ran")
    check(life["spec_accepted"] > 0 or not hold_accepted,
          "no draft token was accepted")
    check(life["logits_pulls"] == 0,
          f"greedy serving pulled logits {life['logits_pulls']} times")
    prefilled = life["prefix_admits"] - life["prefix_hits"]
    check_launches(counts, decoder_launches(core.cfg.n_layers)(
        0, prefilled, lanes=lanes, fused=calls["fused"]), "paged")
    # K3 samples the fused ticks only (verify lanes take the argmax of
    # their logits, as the reference's verify step does): when drafts are
    # accepted all the way (olmoe-1b-7b), every tick may be a verify tick
    path = ("flash_attention", "decode_attention_paged_write") + (
        ("fused_sample",) if calls["fused"] else ())
    check(all(counts[k] > 0 for k in path),
          f"the paged path skipped a kernel: {counts}")
    return counts, streams


# --------------------------------------------------------------------- phase 4


def dense_shared(core, prompts):
    """The dense plain engine on the paged run's prompts and schedule.
    prefill_chunk equals the block size on both sides: a shared prefix was
    computed by another request's ticks, an unshared one by the request's
    own, and they agree bit for bit only when both come from the same
    operations at the same shapes.  Every op of the tick works row by row
    at a fixed (8, 1) batch (MoE's expert slabs too: C = N there), and a
    one-shot prefill of one block runs at the same M on both sides; an
    unchunked 200-token prefill would run the projections at M = 200 on
    one side and M = 8 on the other.  (A VLM raises both to its patches +
    1: the one-shot part is the shared patch prefix on both sides.)"""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core, prefill_chunk=8)
    return run_shared(eng, prompts)


def first_difference(torch, core, prompts, got, want):
    """Where two greedy stream sets first part: the request, the step, the
    two tokens and the logit margin (top 1 less top 2) at that step on
    ``want``'s side, from a one-shot forward over the prompt and ``want``'s
    tokens before the step; None where they agree."""
    import numpy as np
    for rid in sorted(want):
        for step, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                toks = np.concatenate([prompts[rid], want[rid][:step]])
                with torch.no_grad():
                    logits, _ = core.params(model_inputs(torch, core, toks))
                top = logits[0, -1].float().topk(2).values
                return (f"request {rid}, step {step}: {a} vs {b}, logit "
                        f"margin there {(top[0] - top[1]).item():.4g}")
    return None


def model_inputs(torch, core, toks):
    """One prompt as the model's inputs, a VLM's zero patches with it (as
    the engine feeds them)."""
    cfg = core.cfg
    inputs = {"tokens": torch.tensor(toks[None], dtype=torch.int32,
                                     device=core.device)}
    if cfg.family == "vlm":
        inputs["patches"] = torch.zeros(1, cfg.n_vision_patches, cfg.d_model,
                                        dtype=cfg.cdtype, device=core.device)
    return inputs


def full_width_streams_phase(torch, core, prompts, paged_streams):
    """The paged + speculative streams equal the dense plain ones."""
    dense = dense_shared(core, prompts)
    check(dense == paged_streams,
          f"paged + spec streams differ from the dense plain ones at "
          f"{first_difference(torch, core, prompts, paged_streams, dense)}: "
          f"{paged_streams} != {dense}")
    print(f"  {len(dense)} full-width greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense plain), e.g. rid 0: {dense[0]}")


def run_all(eng, requests):
    """Submit every request at once, step to the end and return the greedy
    streams by request id."""
    for r in requests:
        eng.submit(r, now=0.0)
    done, step = [], 0
    while len(done) < len(requests):
        step += 1
        check(step < 5000, "the run did not finish")
        done.extend(eng.step(now=float(step)))
    return {r.rid: list(r.tokens_out) for r in done}


def random_requests(vocab):
    """8 requests of 200 random prompt tokens and 16 generated, seeded."""
    import numpy as np
    from repro_torch.serving import synthetic_requests
    from repro_torch.sim.serving import WorkloadSpec
    return synthetic_requests(WorkloadSpec(prompt_len=200, gen_len=GEN_LEN),
                              SLOTS, vocab, rng=np.random.default_rng(2))


def recurrent_paged_phase(torch, ops, core, label, expected):
    """ServingEngine(pool="paged", spec_k=3) at full width on a model with
    recurrent state: nothing is shared or speculated.  zamba2-2.7b pages
    its shared blocks' K/V (K5's write instance carries every tick, K1's
    none) and keeps the Mamba2 state dense; falcon-mamba-7b has nothing to
    page, and "paged" is the dense pool.  Launch counts must equal
    ``expected(fused ticks, admissions)``."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ, core=core,
                        pool="paged", spec_k=SPEC_K)
    pages = core.cfg.hybrid is not None
    check(eng._paged == pages and not getattr(eng.pool, "can_share", False),
          f"{label}'s paged pool must {'' if pages else 'not '}page the "
          f"attention K/V and share nothing")
    with counted_steps(core) as calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        streams = run_all(eng, random_requests(core.cfg.vocab))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    life = eng.lifetime()
    admitted, hits = eng.stats.total_admitted, life.get("prefix_hits", 0)
    print(f"  {label} paged + spec_k={SPEC_K}: {life['total_tokens']} tokens "
          f"in {wall:.2f} s ({life['total_tokens'] / wall:.1f} tok/s, host "
          f"clock), {calls['fused']} fused + {calls['verify']} verify ticks, "
          f"admissions {admitted}, prefix_hits={hits} spec_proposed="
          f"{life['spec_proposed']} logits_pulls={life['logits_pulls']}")
    check(life["total_completed"] == SLOTS,
          f"{life['total_completed']}/{SLOTS} requests finished")
    check(life["spec_proposed"] == 0 and calls["verify"] == 0,
          f"{label} speculated: recurrent state cannot rewind")
    check(hits == 0, f"{label} shared a prefix")
    check(life["logits_pulls"] == 0,
          f"greedy serving pulled logits {life['logits_pulls']} times")
    check_launches(counts, expected(calls["fused"], admitted),
                   f"{label} paged")
    return counts, streams


def recurrent_streams_phase(core, label, paged_streams):
    """The dense plain engine on the same requests: the same greedy
    streams, request for request (K5 reads the blocks in K1's order, its
    write instance writes what K1's writes, the recurrent state is the
    same)."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ, core=core)
    dense = run_all(eng, random_requests(core.cfg.vocab))
    check(dense == paged_streams,
          f"{label} paged streams {paged_streams} != dense {dense}")
    print(f"  {len(dense)} full-width {label} greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense), e.g. rid 0: {dense[0]}")


def drop_fracs(torch, core, prompts):
    """drop_frac of a one-shot forward over each prompt, averaged over the
    MoE layers (the forward's aux sums them)."""
    out = []
    for p in prompts:
        with torch.no_grad():
            _, aux = core.params({"tokens": torch.tensor(
                p[None], dtype=torch.int32, device=core.device)})
        out.append(aux["drop_frac"].item() / core.cfg.n_layers)
    return out


SMOKE_PATHS = {
    "qwen2.5-3b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    "zamba2-2.7b": (
        ("dense", {}, ("ssm_scan", "flash_attention",
                       "decode_attention_write", "fused_sample")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("ssm_scan", "flash_attention", "decode_attention_paged_write",
          "fused_sample"))),
    "olmoe-1b-7b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    "falcon-mamba-7b": (
        ("dense", {}, ("fused_sample",)),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("fused_sample",))),
    "qwen2-vl-7b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    # an encoder-decoder serves plain with spec_k > 0: every tick is fused
    "seamless-m4t-medium": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "fused_sample",
          "flash_attention"))),
}


def streams_phase(torch, ops, arch):
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import EngineCore

    cfg = get_smoke_config(arch)
    max_seq = 48
    gpu = EngineCore(cfg, max_seq, seed=0, device="cuda")
    cpu = EngineCore(cfg, max_seq, params=copy.deepcopy(gpu.params).to("cpu"),
                     device="cpu")

    def run(core, **kw):
        eng = ServingEngine(cfg, slots=3, max_seq=max_seq, prefill_chunk=6,
                            core=core, **kw)
        rng, frng = np.random.default_rng(0), np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, size=10 + i)
                        .astype(np.int32), gen_len=12,
                        frames=frng.standard_normal((5 + 3 * i, cfg.d_model))
                        .astype(np.float32) if cfg.enc_dec else None)
                for i in range(6)]
        done = []
        for step in range(500):
            for r in reqs[2 * step:2 * step + 2]:       # staggered arrivals
                eng.submit(r, now=float(step))
            done.extend(eng.step(now=float(step)))
            if len(done) == len(reqs):
                return {r.rid: r.tokens_out for r in done}
        raise SmokeFailure("smoke-config streams did not finish")

    for name, kw, path in SMOKE_PATHS[arch]:
        ops.reset_launch_counts()
        on_gpu = run(gpu, **kw)
        counts = ops.launch_counts()
        check(all(counts[k] > 0 for k in path),
              f"smoke serving ({name}) skipped a kernel: {counts}")
        check(all(counts[k] == 0 for k in ROW_WRITES_ALONE),
              f"smoke serving ({name}) ran a standalone row write or "
              f"unfused decode: {counts}")
        on_cpu = run(cpu, **kw)
        check(on_gpu == on_cpu,
              f"{arch} {name}: kernel streams {on_gpu} != plain {on_cpu}")
        print(f"  {arch} smoke, {name}: 6 greedy streams equal (kernels vs "
              f"plain), launches {counts}")


# --------------------------------------------------------------------- phase 5


@contextlib.contextmanager
def annotated(torch, label, objs, method="forward"):
    """Each call of ``method`` on these objects inside a
    ``record_function(label)`` range, by a wrapper set on each instance:
    the model's code is unchanged, and the class's method shows again once
    the block ends."""
    def ranged(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call

    for o in objs:
        setattr(o, method, ranged(getattr(o, method)))
    try:
        yield
    finally:
        for o in objs:
            delattr(o, method)


@contextlib.contextmanager
def timed_scan(torch, stats):
    """Mamba1's ``selective_scan`` inside a ``record_function`` range, its
    host time (the Python loop's launches, no synchronize) and calls added
    to ``stats``."""
    from repro_torch.models import mamba
    scan = mamba.selective_scan

    def wrapped(*args):
        t0 = time.perf_counter()
        with torch.profiler.record_function("selective_scan"):
            out = scan(*args)
        stats["host_s"] += time.perf_counter() - t0
        stats["calls"] += 1
        return out

    mamba.selective_scan = wrapped
    try:
        yield stats
    finally:
        mamba.selective_scan = scan


def range_ms(prof, label, n) -> float:
    """Device ms per step of the kernels launched inside ``label``'s
    ranges (the host-side range events, whose device time sums the
    kernels of every op they enclose)."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key == label and e.device_type == DeviceType.CPU
               ) / 1e3 / n


def tick_floor(torch, eng):
    """(GB, ms) of what a decode tick reads at least once, over 3.35
    TB/s: every Linear's compute-dtype copy, the MoE expert stacks' copies
    and a tied readout's float32 table; for an encoder-decoder not the
    encoder's weights or the cross K/V projections (they run at admission),
    but the cross K/V rows below each active row's cross_len."""
    from repro_torch.models.moe import MoE
    from repro_torch.nn import Linear
    model = eng.params
    skip = set()
    nbytes = 0
    if model.cfg.enc_dec:
        skip = {id(m) for m in model.enc_blocks.modules()} | {
            id(m) for b in model.dec_blocks
            for m in (b.cross_attn.wk, b.cross_attn.wv)}
        cross = eng.pool.cache["cross"]["k"]
        active = torch.as_tensor(eng.active, device=cross.device)
        rows = int(eng.pool.cache["cross_len"][active].sum())
        nbytes += 2 * cross.shape[0] * rows * cross[0, 0, 0].numel() * \
            cross.element_size()
    for m in model.modules():
        if id(m) in skip:
            continue
        if isinstance(m, Linear):
            nbytes += m.w_c.numel() * m.w_c.element_size()
        elif isinstance(m, MoE):
            nbytes += sum(t.numel() * t.element_size()
                          for t in (m.gate_c, m.up_c, m.down_c))
    if model.lm_head is None:
        nbytes += model.embed.table.numel() * model.embed.table.element_size()
    return nbytes / 1e9, nbytes / PEAK_BYTES_S * 1e3


def range_shares(prof, ranges, n, device_ms):
    return "".join(f"; {label} {range_ms(prof, label, n):.3f} ms of device "
                   f"time ({range_ms(prof, label, n) / device_ms:.1%})"
                   for label in ranges)


# ticks torch.profiler records for a tick's device time (its trace is
# parsed on the host in proportion to its events, inside the run's time
# limit)
PROFILED_TICKS = 1


def profile_ticks(torch, eng, label, n, n_prof, counted=None,
                  annotate=contextlib.nullcontext, ranges=()):
    """Host time per tick over ``n`` unprofiled ticks, then device time per
    kernel from torch.profiler over ``n_prof`` more, inside ``annotate()``
    with the device time of each of its ``ranges``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(now=0.0)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / n * 1e3
    before = dict(counted or {})
    with annotate(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step(now=0.0)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n_prof * 1e3
    mix = ""
    if counted is not None:
        mix = (f"; the profiled ticks: {counted['fused'] - before['fused']} "
               f"fused, {counted['verify'] - before['verify']} verify with "
               f"{counted['lanes'] - before['lanes']} lanes")
    device_ms, summed_ms = report_profile(summed_once(prof), n_prof)
    print(f"  {label} tick: {tick_ms:.2f} ms host clock ({n} ticks, "
          f"unprofiled); profiled {prof_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / prof_ms:.0%} of the profiled "
          f"tick; {summed_ms:.2f} ms summed over ops and kernels){mix}"
          f"{range_shares(prof, ranges, n_prof, device_ms)}")
    print_profile(prof, n_prof)


def summed_once(prof):
    """``prof`` with its ``key_averages()`` summed once: a report reads it
    three or four times, and summing a trace takes seconds (tens for a
    tick of four replicas)."""
    averages = prof.key_averages()
    prof.key_averages = lambda: averages
    return prof


def _by_kernel(prof, n, device_only=False):
    """(name, self device ms per step) of the profiled events, largest
    first; ``device_only``: the device's own events (kernels, copies,
    sets), not the host ops that launched them.  A ``record_function``
    range's device-side event spans the device timeline from its first
    kernel to its last, idle time included: it is no work, and left out
    (``range_ms`` reads a range's kernels)."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_device_time_total / 1e3 / n)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and (not device_only or e.device_type == DeviceType.CUDA)),
                  key=lambda kv: -kv[1])


def report_profile(prof, n) -> tuple[float, float]:
    """Device busy ms per profiled step: the device's own events summed,
    and the sum over host ops and device events alike that PRs 11-15
    reported (a kernel launched by an aten op counts there twice, under
    the op and under its own name).  Fails if the profiler saw no device
    time."""
    device_ms = sum(t for _, t in _by_kernel(prof, n, device_only=True))
    check(device_ms > 0, "the profiler saw no device time")
    return device_ms, sum(t for _, t in _by_kernel(prof, n))


def print_profile(prof, n, top=12):
    for name, t in _by_kernel(prof, n)[:top]:
        print(f"    {t:8.3f} ms/step  {name[:90]}")


def random_prompts(cfg, n, prompt_len=200, seed=3):
    """n requests of ``prompt_len`` random prompt tokens, seeded."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab, prompt_len)
                    .astype(np.int32), gen_len=GEN_LEN) for i in range(n)]


def profile_admission(torch, core, label="qwen2.5-3b",
                      kernels=(("K4", "flash"),),
                      annotate=contextlib.nullcontext, ranges=(),
                      requests=None):
    """One admission: the unchunked prefill of a prompt (200 random tokens,
    or each of three ``requests``' prompt and frames) into a free slot
    (``ServingEngine.admit``), after one warm-up admission; its host time
    unprofiled, then another's profiled: device time per kernel, each named
    kernel's share (by a pattern of its CUDA names) and each range's beside
    the rest.  Both run inside an ``annotate()`` of their own.  Returns the
    unprofiled host ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core)
    reqs = requests or random_prompts(core.cfg, 3)
    admit = lambda slot, r: eng.admit(slot, r.prompt, GEN_LEN,
                                      frames=r.frames)
    admit(0, reqs[0])
    torch.cuda.synchronize()
    with annotate():
        t0 = time.perf_counter()
        admit(2, reqs[2])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    with annotate(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        admit(1, reqs[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, summed_ms = report_profile(summed_once(prof), 1)
    shares = []
    for name, pattern in kernels:
        k_ms = sum(t for key, t in _by_kernel(prof, 1, device_only=True)
                   if re.search(pattern, key))
        shares.append(f"{name} {k_ms:.3f} ms ({k_ms / device_ms:.1%} of the "
                      f"device time)")
    enc = ("" if reqs[1].frames is None else
           f", {len(reqs[1].frames)} encoder frames")
    print(f"  {label} admission ({len(reqs[1].prompt)}-token prefill{enc}): "
          f"{plain_ms:.2f} ms host "
          f"clock unprofiled, {wall_ms:.2f} ms profiled, device busy "
          f"{device_ms:.2f} ms ({summed_ms:.2f} ms summed over ops and "
          f"kernels)" + "".join("; " + x for x in shares)
          + range_shares(prof, ranges, 1, device_ms))
    print_profile(prof, 1)
    del eng
    free(torch)
    return plain_ms


def profile_dense_tick(torch, core, label, requests=None, **kw):
    """Dense plain: 8 slots, prompts (8 of 200 random tokens, or
    ``requests``) streaming through the tick, as with --prefill-chunk 64;
    the byte floor of a tick beside it."""
    import numpy as np
    from repro_torch.serving import ServingEngine, synthetic_requests
    from repro_torch.sim.serving import WorkloadSpec

    cfg = core.cfg
    eng = ServingEngine(cfg, slots=SLOTS, max_seq=core.max_seq,
                        prefill_chunk=64, core=core)
    if requests is None:
        requests = synthetic_requests(
            WorkloadSpec(prompt_len=200, gen_len=16), 8, cfg.vocab,
            rng=np.random.default_rng(0))
    for r in requests:
        eng.submit(r)
    for _ in range(4):                  # admit every request, warm up
        eng.step(now=0.0)
    gb, floor_ms = tick_floor(torch, eng)
    what = "weights and cross K/V" if cfg.enc_dec else "weights"
    print(f"  {label}: a tick reads at least {gb:.2f} GB of {what}, a byte "
          f"floor of {floor_ms:.3f} ms at 3.35 TB/s")
    profile_ticks(torch, eng, label, n=5, n_prof=PROFILED_TICKS, **kw)


def profile_phase(torch, core, prompts):
    """Where a full-width qwen tick's time goes: the dense plain tick, then
    paged + speculative: the 8 shared-prefix prompts admitted at once,
    prefill chunk one block, so the window holds verify ticks (prompt lanes
    streaming, then drafts)."""
    from repro_torch.serving import Request, ServingEngine

    cfg = core.cfg
    profile_dense_tick(torch, core, "dense plain decode")
    eng = ServingEngine(cfg, slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=8,
                        core=core, pool="paged", spec_k=SPEC_K)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, gen_len=GEN_LEN))
    for _ in range(4):
        eng.step(now=0.0)
    with counted_steps(core) as calls:
        profile_ticks(torch, eng, f"paged + spec_k={SPEC_K}", n=5,
                      n_prof=PROFILED_TICKS, counted=calls)
    del eng
    free(torch)
    profile_admission(torch, core)


def free(torch):
    """Drop what the last phase left and return the card's cached blocks
    (the next model needs the room)."""
    gc.collect()
    torch.cuda.empty_cache()


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def depth_cut(arch):
    """The full-width config of ``arch`` at DEPTH_CUT[arch] layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=DEPTH_CUT[arch])


@contextlib.contextmanager
def serving_config(serve, cfg):
    """The serve CLI builds ``cfg`` for ``--arch cfg.name`` (a depth-cut
    copy) while the block runs."""
    real = serve.get_config
    serve.get_config = lambda arch, **kw: (cfg if arch == cfg.name
                                           else real(arch, **kw))
    try:
        yield
    finally:
        serve.get_config = real


@contextlib.contextmanager
def phase_clock(times, name):
    """Time the block as phase ``name`` into ``times`` and print it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = round(time.perf_counter() - t0, 1)
        print(f"  ({name}: {times[name]} s)", flush=True)


def olmoe_phases(torch, ops, serve, EngineCore, cfg, add):
    """olmoe-1b-7b at full width and a quarter of its depth (``cfg``, cut
    by ``depth_cut``): the CLI at the published capacity factor
    1.25 (an unchunked 200-token prefill drops tokens); the paged +
    speculative run, the dense plain streams and phase 5 on a dropless
    copy (capacity_factor = E/K: C = N·K, so no expert can overflow and the
    streams cannot depend on which tokens share a batch); then the same
    two runs at 1.25, their streams compared and printed, not held equal,
    beside the drop_frac of one-shot forwards over the prompts."""
    import dataclasses
    print(f"[3] serve olmoe-1b-7b at full width, {cfg.n_layers} layers "
          f"(capacity factor {cfg.moe.capacity_factor})")
    t0 = time.perf_counter()
    with serving_config(serve, cfg):
        add(serve_phase(torch, ops, serve, OSERVE,
                        decoder_launches(cfg.n_layers)))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / K))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(dropless, MAX_SEQ, seed=0, device="cuda")
    print(f"  dropless copy, capacity_factor = E/K = {E / K:g}: C = N·K, no "
          f"expert can overflow; the stream equality of phase 4 is held on "
          f"it")
    prompts = shared_prompts(core)
    launches, streams = paged_serve_phase(torch, ops, core, prompts)
    add(launches)
    drops = drop_fracs(torch, core, prompts)
    check(max(drops) == 0.0, f"the dropless copy dropped tokens: {drops}")
    print("[4] greedy streams on the card: olmoe-1b-7b (dropless copy)")
    full_width_streams_phase(torch, core, prompts, streams)
    streams_phase(torch, ops, "olmoe-1b-7b")
    print("[5] where a full-width olmoe-1b-7b tick's and admission's time "
          "goes (dropless copy)")
    moe = [blk.moe for blk in core.params.blocks]
    annotate = lambda: annotated(torch, "moe", moe)
    profile_dense_tick(torch, core, "olmoe dense decode", annotate=annotate,
                       ranges=("moe",))
    profile_admission(torch, core, "olmoe-1b-7b", annotate=annotate,
                      ranges=("moe",))
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core, moe, annotate
    free(torch)
    print(f"[3] olmoe-1b-7b at capacity factor {cfg.moe.capacity_factor}: "
          f"the paged + speculative run and the dense plain streams")
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = paged_serve_phase(torch, ops, core, prompts)
    add(launches)
    dense = dense_shared(core, prompts)
    where = first_difference(torch, core, prompts, streams, dense)
    drops = drop_fracs(torch, core, prompts)
    print(f"  streams {'equal' if where is None else 'differ: ' + where} "
          f"(not held: with drops a token's experts depend on its batch); "
          f"one-shot forward over each {len(prompts[0])}-token prompt: "
          f"drop_frac per layer {min(drops):.4f} to {max(drops):.4f}")
    del core
    free(torch)
    print(f"  olmoe-1b-7b: {time.perf_counter() - t0:.1f} s")


def falcon_phases(torch, ops, serve, EngineCore, cfg, add):
    """falcon-mamba-7b at full width and a quarter of its depth (``cfg``,
    cut by ``depth_cut``): the CLI, the paged + speculative
    engine (nothing to page, nothing speculated), its streams against the
    dense engine's, and phase 5 with the selective scan's host time."""
    print(f"[3] serve falcon-mamba-7b at full width, {cfg.n_layers} layers")
    t0 = time.perf_counter()
    with serving_config(serve, cfg):
        add(serve_phase(torch, ops, serve, FSERVE, mamba1_launches))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = recurrent_paged_phase(torch, ops, core,
                                              "falcon-mamba-7b",
                                              mamba1_launches)
    add(launches)
    print("[4] greedy streams on the card: falcon-mamba-7b")
    recurrent_streams_phase(core, "falcon-mamba-7b", streams)
    streams_phase(torch, ops, "falcon-mamba-7b")
    print("[5] where a full-width falcon-mamba-7b tick's and admission's "
          "time goes")
    profile_dense_tick(torch, core, "falcon dense decode")
    scans = []                  # per admission: the scans' host time

    def annotate():
        scans.append({"host_s": 0.0, "calls": 0})
        return timed_scan(torch, scans[-1])

    plain_ms = profile_admission(torch, core, "falcon-mamba-7b", kernels=(),
                                 annotate=annotate,
                                 ranges=("selective_scan",))
    scan_ms = scans[0]["host_s"] * 1e3
    print(f"  the unprofiled admission's {scans[0]['calls']} selective "
          f"scans: {scan_ms:.2f} ms host clock ({scan_ms / plain_ms:.0%}; "
          f"the loop's launches, 199 a layer, no synchronize)")
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core
    free(torch)
    print(f"  falcon-mamba-7b: {time.perf_counter() - t0:.1f} s")


def vlm_phases(torch, ops, serve, EngineCore, cfg, add):
    """qwen2-vl-7b at full width: the CLI (1224-token prompts: 1024 patch
    positions and 200 text tokens), the paged + speculative run on the
    shared-prefix prompts behind 1024 shared patch positions, its streams
    against the dense plain engine's, and phase 5.  With random weights
    this model's greedy streams repeat no token (as qwen2.5-3b's and
    olmoe-1b-7b's do), so the prompt-lookup drafts it proposes are not
    accepted: proposed drafts and verify windows are held, accepted ones
    printed."""
    print("[3] serve qwen2-vl-7b at full width")
    t0 = time.perf_counter()
    add(serve_phase(torch, ops, serve, VSERVE,
                    decoder_launches(cfg.n_layers)))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, VL_MAX_SEQ, seed=0, device="cuda")
    prompts = shared_prompts(core)
    launches, streams = paged_serve_phase(torch, ops, core, prompts,
                                          hold_accepted=False)
    add(launches)
    print("[4] greedy streams on the card: qwen2-vl-7b")
    full_width_streams_phase(torch, core, prompts, streams)
    streams_phase(torch, ops, "qwen2-vl-7b")
    print("[5] where a full-width qwen2-vl-7b tick's and admission's time "
          "goes")
    profile_dense_tick(torch, core, "qwen2-vl dense decode",
                       requests=random_prompts(cfg, SLOTS, VL_PROMPT, 0))
    profile_admission(torch, core, "qwen2-vl-7b",
                      requests=random_prompts(cfg, 3, VL_PROMPT))
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core
    free(torch)
    print(f"  qwen2-vl-7b: {time.perf_counter() - t0:.1f} s")


def encdec_requests(cfg):
    """8 requests of a 200-token decoder prompt and 16 generated, over
    frames of distinct encoder lengths in 128..MAX_SEQ, drawn from
    ENC_SEED."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(ENC_SEED)
    lens = rng.choice(np.arange(128, MAX_SEQ + 1), SLOTS, replace=False)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab, 200)
                    .astype(np.int32), gen_len=GEN_LEN,
                    frames=rng.standard_normal((int(n), cfg.d_model))
                    .astype(np.float32)) for i, n in enumerate(lens)]


def encdec_serve_phase(torch, ops, core):
    """ServingEngine at full width on encdec_requests: the dense pool
    unchunked and chunked by 64, and the paged pool with spec_k=3 (it
    serves plain: nothing is speculated or shared).  Every slot holds its
    own encoder length, so cross_len differs across the slots on every
    tick.  Launch counts: 12 K4 per admission (none from the encoder or
    the cross attention, which are plain, as in the reference), 12 K1 (or
    K5) write instances a tick, one K3 a tick.  Returns the launches and
    the streams by run."""
    from repro_torch.serving import ServingEngine
    L = core.cfg.n_layers
    launches, streams = {name: 0 for name in ops.KERNELS}, {}
    lens = sorted(len(r.frames) for r in encdec_requests(core.cfg))
    for label, chunk, kw in (
            ("dense", None, {}), ("dense, prefill chunk 64", 64, {}),
            (f"paged + spec_k={SPEC_K}", None,
             dict(pool="paged", spec_k=SPEC_K))):
        eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                            core=core, prefill_chunk=chunk, **kw)
        paged = bool(kw)
        check(eng._paged == paged and not getattr(eng.pool, "can_share",
                                                  False),
              f"seamless {label}: the pool must page the self K/V only "
              f"when asked and share nothing")
        with counted_steps(core) as calls:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            streams[label] = run_all(eng, encdec_requests(core.cfg))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            wall = time.perf_counter() - t0
        life = eng.lifetime()
        admitted, ticks = eng.stats.total_admitted, calls["fused"]
        cross_len = sorted(eng.pool.cache["cross_len"].tolist())
        print(f"  seamless {label}: {life['total_tokens']} tokens in "
              f"{wall:.2f} s ({life['total_tokens'] / wall:.1f} tok/s, host "
              f"clock), {ticks} fused + {calls['verify']} verify ticks, "
              f"admissions {admitted}, cross_len over the slots {cross_len}, "
              f"spec_proposed={life['spec_proposed']} "
              f"logits_pulls={life['logits_pulls']}")
        check(life["total_completed"] == SLOTS,
              f"{life['total_completed']}/{SLOTS} requests finished")
        check(cross_len == lens, f"cross_len {cross_len} != the encoder "
                                 f"lengths {lens}")
        check(life["spec_proposed"] == 0 and calls["verify"] == 0,
              "an encoder-decoder speculated: it serves plain")
        check(life.get("prefix_hits", 0) == 0, "seamless shared a prefix")
        check(life["logits_pulls"] == 0,
              f"greedy serving pulled logits {life['logits_pulls']} times")
        want = (decoder_launches(L)(0, admitted, lanes=ticks, fused=ticks)
                if paged else decoder_launches(L)(ticks, admitted))
        check_launches(counts, want, f"seamless {label}")
        for name in launches:
            launches[name] += counts[name]
        del eng
        free(torch)
    return launches, streams


def encdec_phases(torch, ops, EngineCore, cfg, add):
    """seamless-m4t-medium at full width through ServingEngine (the CLI
    makes no frames, as in the reference), its paged streams against the
    dense ones, and phase 5 with the encoder's and the cross attention's
    device time as ranges."""
    print("[3] serve seamless-m4t-medium at full width (ServingEngine, "
          "frames of encoder lengths 128..1024)")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = encdec_serve_phase(torch, ops, core)
    add(launches)
    print("[4] greedy streams on the card: seamless-m4t-medium")
    dense, paged = streams["dense"], streams[f"paged + spec_k={SPEC_K}"]
    check(paged == dense, f"seamless paged streams {paged} != dense {dense}")
    chunked = streams["dense, prefill chunk 64"]
    print(f"  {len(dense)} full-width seamless greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense), e.g. rid 0: {dense[0]}; chunked by "
          f"64 {'equal' if chunked == dense else 'not equal'} (not held: "
          f"the one-shot part runs at other shapes)")
    streams_phase(torch, ops, "seamless-m4t-medium")
    print("[5] where a full-width seamless-m4t-medium tick's and admission's "
          "time goes")
    model = core.params
    cross = [blk.cross_attn for blk in model.dec_blocks]

    def annotate():
        stack = contextlib.ExitStack()
        stack.enter_context(annotated(torch, "encoder", [model], "_encode"))
        stack.enter_context(annotated(torch, "cross_attn", cross))
        stack.enter_context(annotated(torch, "cross_attn", cross,
                                      "_decode_cross"))
        return stack

    profile_dense_tick(torch, core, "seamless dense decode",
                       requests=encdec_requests(cfg), annotate=annotate,
                       ranges=("cross_attn",))
    profile_admission(torch, core, "seamless-m4t-medium", annotate=annotate,
                      ranges=("encoder", "cross_attn"),
                      requests=encdec_requests(cfg)[:3])
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core, model, cross, annotate
    free(torch)
    print(f"  seamless-m4t-medium: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 6


def loop_shapes_phase(torch, ops, ref):
    """The attention kernels at the shapes the closed loop gives them
    (``LoopConfig()``: 4 slots, max_seq 48, a first chunk of 8 tokens):
    K4 at (1,8,16,128) over 2 KV heads in bf16, held to ATTN_TOL and timed
    beside its plain version and SDPA; the write instances of K1 and K5
    over a max_seq-48 cache, 4 rows, bitwise against K2, K2, K1 (K6, K6,
    K5).  K3 at (4, 151936) runs in ``sample_rows``.  Printed; the kernels
    line keeps its shapes."""
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(29)
    S, H, KV, hd = LOOP_CHUNK, 16, 2, 128
    randn = lambda *shape: torch.randn(*shape, generator=g,
                                       device=dev).to(bf16)
    q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    kernel = lambda: ops.flash_attention(q, k, v, causal=True)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal=True)
    err = max_err(torch, kernel(), plain(), ATTN_TOL,
                  f"flash_attention [loop, (1,{S},{H},{hd})]")
    library = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    b_ms, b_by = bound((2 * S * H * hd + 2 * S * KV * hd) * 2,
                       4 * (S * (S + 1) // 2) * H * hd, PEAK_BF16_S)
    print(f"  qwen2.5-3b loop flash_attention (1,{S},{H},{hd}) KV {KV}: "
          f"kernel {timed_ms(torch, kernel):.4f} ms, plain "
          f"{timed_ms(torch, plain):.4f} ms, library "
          f"{timed_ms(torch, library):.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}), max|err| {err}")
    for paged in (False, True):
        write_instance_row(torch, ops, ref, g, "qwen2.5-3b loop", H, KV, hd,
                           paged, Smax=LOOP_MAX_SEQ, B=LOOP_SLOTS,
                           indices=LOOP_WRITE_INDICES)


def no_backward_phase(torch, ops):
    """The prefill kernels (K4, K7) fill their outputs through ctypes, which
    autograd cannot see: with grad enabled and an input that requires it
    they raise ``NoBackwardError`` and launch nothing; under
    ``torch.no_grad`` (as serving runs) the same call launches."""
    from repro_torch.kernels._lib import NoBackwardError
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    calls = {
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True),
                            [randn(1, 16, 4, 64).bfloat16(),
                             randn(1, 16, 2, 64).bfloat16(),
                             randn(1, 16, 2, 64).bfloat16()]),
        "ssm_scan": (ops.ssm_scan,
                     [randn(1, 64, 4, 64), randn(1, 64, 4).abs(),
                      -randn(4).abs(), randn(1, 64, 4, 64),
                      randn(1, 64, 4, 64)]),
    }
    for name, (call, args) in calls.items():
        args[0].requires_grad_(True)
        before = ops.launch_counts()[name]
        try:
            call(*args)
        except NoBackwardError:
            pass
        else:
            raise SmokeFailure(f"{name}: a grad-requiring input did not raise")
        check(ops.launch_counts()[name] == before,
              f"{name}: launched although it raised")
        with torch.no_grad():
            call(*args)
        check(ops.launch_counts()[name] == before + 1,
              f"{name}: did not launch under torch.no_grad")
    print("  flash_attention and ssm_scan raise NoBackwardError on an input "
          "that requires grad (no launch) and launch under torch.no_grad")


def tick_line(t) -> str:
    """One TickLog as ``examples/serve_autoscale.py`` prints it."""
    util = " ".join(f"r{rid}={u:.2f}" for rid, u in t.replica_util)
    flag = " [ANOMALY]" if t.anomaly else ""
    if t.evicted:
        flag += f" [EVICTED r{','.join(map(str, t.evicted))}]"
    return (f"tick {t.tick:2d}: rps={t.rps_target:4.1f} "
            f"arrivals={t.arrivals:2d} served={t.served:2d} "
            f"p50={t.latency_p50_ms:6.0f}ms p95={t.latency_p95_ms:6.0f}ms "
            f"queue={t.queue_depth:4.1f} slot_util[{util}] "
            f"-> {t.replicas} replicas ({t.reason}){flag}")


def trajectory(logs) -> list[dict]:
    """Every TickLog field but ``learn_loss`` (the DQN's, held apart)."""
    import dataclasses
    return [{k: v for k, v in dataclasses.asdict(t).items()
             if k != "learn_loss"} for t in logs]


@contextlib.contextmanager
def timed_router_steps(torch, steps, after_step=None):
    """The host time of every ``ReplicaRouter.step``, synchronised at its
    end, appended to ``steps``; ``after_step(len(steps))`` runs after each
    one is timed."""
    from repro_torch.serving.router import ReplicaRouter
    step = ReplicaRouter.step

    def timed(self, now=0.0):
        t0 = time.perf_counter()
        out = step(self, now)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(len(steps))
        return out

    ReplicaRouter.step = timed
    try:
        yield steps
    finally:
        ReplicaRouter.step = step


def loop_launches(cfg, router, paged):
    """The launch counts a loop run must show, from every engine the router
    built (parked and retired ones too): 36 K4 an admission that ran a
    prefill, 36 K1 write instances a fused dense tick (K5's a fused paged
    tick or verify lane), one K3 a fused tick."""
    engines = [rep.engine for rep in router.all_replicas]
    fused = sum(e.fused_ticks for e in engines)
    lanes = sum(e.verify_lanes for e in engines)
    prefilled = sum(e.stats.total_admitted
                    - e.lifetime().get("prefix_hits", 0) for e in engines)
    launches = decoder_launches(cfg.n_layers)
    if paged:
        want = launches(0, prefilled, lanes=fused + lanes, fused=fused)
    else:
        want = launches(fused, prefilled)
    return want, dict(engines=len(engines), fused=fused, lanes=lanes,
                      prefilled=prefilled)


def loop_run(torch, ops, cfg, lc, label, seed, profiled=None, recorder=None,
             prime=None):
    """``run_closed_loop`` on the card, the launch counts set to 0 just
    before and read just after; every tick printed, the fleet totals, the
    host clock per router step and per control tick (the loop's work
    outside ``router.step``), the peak memory.  ``profiled`` = (first,
    last) tick whose first ``LOOP_PROFILED_STEPS`` router steps
    torch.profiler records (device busy); those ticks stay out of the
    host-clock means.  ``recorder`` takes the
    loop's per-tick training records; ``prime(alloc)`` runs before the
    first tick, after the allocator is kept."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.closed_loop import run_closed_loop
    sink, allocs, marks, steps = [], {}, [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def keep(alloc):
        allocs["alloc"] = alloc
        if prime is not None:
            prime(alloc)

    def hook(tick, router, collector):
        # the profiler starts where the profiled ticks start
        marks.append((time.perf_counter(), len(steps)))
        if profiled and tick == profiled[0] - 1:
            prof.start()
            window["start"] = (time.perf_counter(), len(steps))

    def after_step(n):
        if ("start" in window and "stop" not in window
                and n - window["start"][1] == LOOP_PROFILED_STEPS):
            window["stop"] = (time.perf_counter(), n)
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_router_steps(torch, steps, after_step):
        router, logs = run_closed_loop(
            cfg, autoscale=True, ticks=LOOP_TICKS, seed=seed, lc=lc,
            sink=sink, chaos_hook=hook, device="cuda", recorder=recorder,
            prime_allocator=keep)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    print(f"  {label}: {len(logs)} ticks of {lc.steps_per_tick} router "
          f"steps, {wall:.1f} s with weight init")
    for t in logs:
        print("    " + tick_line(t))
    m = router.metrics()
    print(f"    fleet totals: {m['completed']} requests, "
          f"{m['completed_tokens']} tokens, p50={m['latency_p50_ms']:.0f}ms "
          f"p95={m['latency_p95_ms']:.0f}ms (virtual clock), slot "
          f"utilization {m['slot_utilization']:.3f}, spec "
          f"{m['spec_accepted']}/{m['spec_proposed']} accepted, prefix hits "
          f"{m['prefix_hits']}")
    check(m["completed"] == len(sink) > 0, f"{label}: {m['completed']} "
          f"completed, {len(sink)} in the sink")
    want, seen = loop_launches(cfg, router, lc.pool == "paged")
    print(f"    engines built {seen['engines']}: {seen['fused']} fused "
          f"ticks, {seen['lanes']} verify lanes, {seen['prefilled']} "
          f"admissions prefilled")
    check_launches(counts, want, f"loop {label}")
    skip = {0} | (set(range(profiled[0], profiled[1] + 1)) if profiled
                  else set())
    step_s, ctrl_s = tick_clocks(t0, marks, steps, skip)
    print(f"    host clock: router step {statistics.mean(step_s) * 1e3:.2f} "
          f"ms mean ({statistics.median(step_s) * 1e3:.2f} median, "
          f"{len(step_s)} steps), control tick outside the router steps "
          f"{statistics.mean(ctrl_s) * 1e3:.2f} ms mean over {len(ctrl_s)} "
          f"ticks; peak device memory {peak_gib(torch):.2f} GiB")
    if profiled:
        (ta, na), (tb, nb) = window["start"], window["stop"]
        device_ms, summed_ms = report_profile(summed_once(prof), nb - na)
        step_ms = (tb - ta) / (nb - na) * 1e3
        print(f"    profiled tick{'s' if profiled[1] > profiled[0] else ''} "
              f"{'-'.join(map(str, sorted(set(profiled))))} "
              f"({nb - na} router steps): {step_ms:.2f} ms host clock a "
              f"router step with its share of the control loop, device "
              f"busy {device_ms:.2f} ms a step ({device_ms / step_ms:.0%}; "
              f"{summed_ms:.2f} ms summed over ops and kernels)")
        print_profile(prof, nb - na, top=8)
    streams = {r.rid: list(r.tokens_out) for r in sink}
    recorded = {k: v[:allocs["alloc"].agent.buffer.n].copy()
                for k, v in allocs["alloc"].agent.buffer.data.items()}
    router.close()
    print(f"    {label}: {time.perf_counter() - t0:.1f} s with the reports")
    return dict(logs=logs, streams=streams, counts=counts,
                recorded=recorded, alloc=allocs["alloc"],
                step_ms=(statistics.mean(step_s) * 1e3,
                         statistics.median(step_s) * 1e3))


def tick_clocks(t0, marks, steps, skip):
    """Host clock per router step and per control tick outside the router
    steps: tick i spans mark i-1 .. mark i (``marks`` = (time, steps so
    far) taken at each tick's hook), its router steps are
    steps[n_{i-1}:n_i], the rest of the tick is the control loop's.  The
    ticks in ``skip`` stay out (tick 0: weight init before it; profiled
    ticks)."""
    prev, step_s, ctrl_s = (t0, 0), [], []
    for tick, (t, n) in enumerate(marks):
        if tick not in skip:
            in_steps = sum(steps[prev[1]:n])
            step_s.extend(steps[prev[1]:n])
            ctrl_s.append(t - prev[0] - in_steps)
        prev = (t, n)
    return step_s, ctrl_s


def dnn_tree(net):
    """The port DNN's parameters as the reference's tree of numpy arrays
    (a digit in a name indexes a list): what the weight bridge reads."""
    tree = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


def dqn_phase(torch, recorded, seed):
    """The allocator's DQN on the card against the CPU: one set of weights
    bridged into an agent on each; q-values on the loop's recorded states
    within DQN_TOL; both buffers filled with the same DQN_TRANSITIONS
    transitions drawn from ``seed``, then DQN_STEPS ``train_offline``
    steps: losses within DQN_TOL, replay draws equal, parameters within
    DQN_TOL but ``dep1.b`` and ``dep2.b``, which feed a training-mode
    BatchNorm and so have no gradient but rounding noise (AdamW turns that
    into steps of up to 1.2·lr, in a direction each device's rounding
    picks), held to that bound, as the running means that absorb them.
    Times ``q_values`` and one train step on each device."""
    import numpy as np
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn.model import DNNConfig, MultiStreamDNN
    cfg = DNNConfig()
    src = MultiStreamDNN(cfg, seed=seed, device="cpu")
    tree = dnn_tree(src)
    state = {bn: {k: v.numpy() for k, v in d.items()}
             for bn, d in src.init_state().items()}
    agents = {dev: DQNAgent(cfg, seed=seed, device=dev)
              for dev in ("cuda", "cpu")}
    for a in agents.values():
        a.load_reference(tree, state)
    n = recorded["deploy"].shape[0]
    check(n > 0, "the loop recorded no allocator state")
    q = {dev: np.stack([a.q_values({k: v[i:i + 1]
                                    for k, v in recorded.items()})
                        for i in range(n)]) for dev, a in agents.items()}
    q_err = float(np.abs(q["cuda"] - q["cpu"]).max())
    check(q_err <= DQN_TOL, f"DQN q-values, card vs CPU: max |err| {q_err}")
    rng = np.random.default_rng(seed)
    shapes = {"resource": (cfg.window, cfg.n_resource_features),
              "perf": (cfg.window, cfg.n_perf_features),
              "deploy": (cfg.n_deploy_features,)}
    draw = lambda: {k: rng.normal(size=(1,) + s).astype(np.float32)
                    for k, s in shapes.items()}
    for _ in range(DQN_TRANSITIONS):
        tr = (draw(), int(rng.integers(7)), float(rng.normal()), draw(),
              bool(rng.random() < 0.1))
        for a in agents.values():
            a.buffer.push(*tr)
    losses = {dev: a.train_offline(DQN_STEPS) for dev, a in agents.items()}
    loss_err = float(np.abs(np.subtract(losses["cuda"], losses["cpu"])).max())
    check(loss_err <= DQN_TOL, f"DQN losses, card vs CPU: max |err| "
                               f"{loss_err}")
    check(agents["cuda"].rng.bit_generator.state
          == agents["cpu"].rng.bit_generator.state,
          "the two agents' replay draws differ")
    drift = 2 * 1.2 * agents["cpu"].cfg.lr * DQN_STEPS
    p_err, zero_err = 0.0, 0.0
    cpu = agents["cpu"].params
    for name, p in agents["cuda"].params.items():
        e = float((p.detach().cpu() - cpu[name].detach()).abs().max())
        if name in ("dep1.b", "dep2.b"):
            zero_err = max(zero_err, e)
        else:
            p_err = max(p_err, e)
    check(p_err <= DQN_TOL, f"DQN params, card vs CPU: max |err| {p_err}")
    check(zero_err <= DQN_TOL + drift, f"DQN pre-BatchNorm biases drifted "
                                       f"{zero_err}, past Adam's bound")
    bn_err = 0.0
    for bn, d in agents["cuda"].bn_state.items():
        for k, v in d.items():
            e = float((v.cpu() - agents["cpu"].bn_state[bn][k]).abs().max())
            check(e <= DQN_TOL + (drift if k == "mean" else 0.0),
                  f"DQN {bn} {k}, card vs CPU: max |err| {e}")
            bn_err = max(bn_err, e)
    state1 = {k: v[:1] for k, v in recorded.items()}
    times = {}
    for dev, a in agents.items():
        t_q = []
        for _ in range(20):
            t0 = time.perf_counter()
            a.q_values(state1)
            t_q.append(time.perf_counter() - t0)
        t_train = []
        for _ in range(5):
            t0 = time.perf_counter()
            a.train_offline(1)
            t_train.append(time.perf_counter() - t0)
        times[dev] = (statistics.median(t_q) * 1e3,
                      statistics.median(t_train) * 1e3)
    print(f"  DQN card vs CPU, one set of bridged weights: q-values on the "
          f"loop's {n} recorded states max |err| {q_err:.3g}; "
          f"{DQN_STEPS} train_offline steps over {DQN_TRANSITIONS} "
          f"transitions: losses max |err| {loss_err:.3g}, params "
          f"{p_err:.3g} (dep1.b, dep2.b {zero_err:.3g}, bound "
          f"{DQN_TOL + drift:.3g}), BatchNorm state {bn_err:.3g}")
    for dev, (t_q, t_train) in times.items():
        print(f"    {dev}: q_values {t_q:.2f} ms, one train step "
              f"{t_train:.2f} ms (host clock, median)")


def loop_phase(torch, ops, seed, add):
    """The paper's closed control loop through the port on the card:
    ``run_closed_loop`` with ``LoopConfig()`` on full-width qwen2.5-3b, as
    ``examples/serve_autoscale.py`` drives the reference's; then with the
    paged pool and speculation (streams equal the dense run's, request for
    request); the card's trajectory against the same loop on the CPU at
    smoke width and qwen's vocabulary; the DQN card against CPU."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.dnn.traces import TraceRecorder
    from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
    cfg = get_config("qwen2.5-3b")
    lc = LoopConfig()
    card_rec, cpu_rec = TraceRecorder(), TraceRecorder()
    check((lc.slots, lc.max_seq, lc.prefill_chunk)
          == (LOOP_SLOTS, LOOP_MAX_SEQ, LOOP_CHUNK),
          "LoopConfig() is not the shape phase 2 checked")
    print(f"[6] the closed control loop on full-width qwen2.5-3b: "
          f"run_closed_loop({LOOP_TICKS} ticks, seed {seed}, autoscale, "
          f"{lc.slots} slots, max_seq {lc.max_seq}, prefill chunk "
          f"{lc.prefill_chunk}, up to {lc.max_replicas} in-process replicas "
          f"sharing one EngineCore, planner mode)")
    t0 = time.perf_counter()
    dense = loop_run(torch, ops, cfg, lc, "dense pool", seed,
                     profiled=LOOP_PROFILED, recorder=card_rec)
    add(dense["counts"])
    traj = [1] + [t.replicas for t in dense["logs"]]
    check(len(set(traj)) > 1, "the scaler never changed the replica count")
    print(f"  replica trajectory: {traj}")
    free(torch)
    paged = loop_run(torch, ops, cfg,
                     dataclasses.replace(lc, pool="paged", spec_k=SPEC_K),
                     f"paged pool + spec_k={SPEC_K}", seed)
    add(paged["counts"])
    # speculation finishes requests sooner, so the two runs' trajectories
    # may differ: every request the dense run finished must have finished
    # in the paged run too, or still be in flight when it ended (rids run
    # 0.. in arrival order), and a request both finished has one stream
    in_flight = (set(range(sum(t.arrivals for t in paged["logs"])))
                 - set(paged["streams"]))
    lost = sorted(set(dense["streams"]) - set(paged["streams"]) - in_flight)
    check(not lost, f"the paged + speculative loop lost requests {lost} "
                    f"that the dense loop finished")
    both = sorted(set(paged["streams"]) & set(dense["streams"]))
    differ = [rid for rid in both
              if paged["streams"][rid] != dense["streams"][rid]]
    check(not differ, f"the paged + speculative loop's streams differ from "
                      f"the dense loop's for requests {differ}")
    print(f"  paged + speculative streams equal the dense loop's for all "
          f"{len(both)} requests both finished (dense "
          f"{len(dense['streams'])}, paged {len(paged['streams'])}; "
          f"{len(dense['streams']) - len(both)} dense-finished requests "
          f"still in flight when the paged run ended)")
    free(torch)
    smoke = get_smoke_config("qwen2.5-3b", vocab=cfg.vocab)
    t1 = time.perf_counter()
    router, cpu_logs = run_closed_loop(smoke, autoscale=True,
                                       ticks=LOOP_TICKS, seed=seed, lc=lc,
                                       device="cpu", recorder=cpu_rec)
    router.close()
    want, got = trajectory(cpu_logs), trajectory(dense["logs"])
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    check(len(got) == len(want) and diff is None,
          f"the card's trajectory differs from the CPU smoke run's at tick "
          f"{diff}: {got[diff] if diff is not None else ''} vs "
          f"{want[diff] if diff is not None else ''}")
    print(f"  the card's {len(got)} TickLogs (every field but learn_loss) "
          f"equal the CPU's at smoke width, vocab {cfg.vocab} "
          f"({time.perf_counter() - t1:.1f} s on the CPU)")
    t1 = time.perf_counter()
    dqn_phase(torch, dense["recorded"], seed)
    print(f"  closed loop: {time.perf_counter() - t0:.1f} s (the DQN check "
          f"{time.perf_counter() - t1:.1f} s)")
    return dict(cfg=cfg, smoke=smoke, lc=lc, planner=dense,
                card_trace=card_rec.records, cpu_trace=cpu_rec.records)


# --------------------------------------------------------------------- phase 7
# the offline learning path on the planner trace phase 6 recorded:
# pretrain_on_trace at the reference's defaults, the hybrid loop it primes,
# permutation importance, the strategy head and a canary rollout
PRETRAIN_TOL, ROLLOUT_TICKS = 1e-4, 20
# the elements whose gradient is rounding noise when every row of a batch
# carries one deployment vector, as a recorded trace does: the deployment
# stream before its last normalisation, bn2's bias behind its ReLU at 0,
# and the trunk's first-layer rows that read that ReLU (the deployment
# features come last, after 2 x 32 conv and 32 GRU features)
NOISE_LEAVES = ("dep1.w", "dep1.b", "bn1.scale", "bn1.bias", "dep2.w",
                "dep2.b", "bn2.scale", "bn2.bias")
NOISE_ROWS = ("trunk.layers.0.w", 96)
# lr x steps summed over pretrain_on_trace's defaults: 20 supervised and 30
# imitation steps at 1e-3, 60 DQN steps at 5e-4
PRETRAIN_LR_STEPS = 20 * 1e-3 + 30 * 1e-3 + 60 * 5e-4


@contextlib.contextmanager
def timed_pretrain(torch, clocks):
    """The host clock of ``pretrain_on_trace``'s three phases (supervised
    ``fit``, DQN replay, Q-head imitation), synchronised at each end, and
    the network's parameters after each (``clocks["after"][phase]``, a
    flat dict of numpy arrays)."""
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn import traces
    saved = traces.fit, DQNAgent.train_offline, DQNAgent.imitate

    def timed(name, fn):
        def run(first, *args, **kw):
            t0 = time.perf_counter()
            out = fn(first, *args, **kw)
            torch.cuda.synchronize()
            clocks[name] = time.perf_counter() - t0
            net = getattr(first, "net", first)     # fit takes the network
            clocks.setdefault("after", {})[name] = flat_tree(
                copy.deepcopy(dnn_tree(net)))
            return out
        return run

    traces.fit = timed("supervised", saved[0])
    DQNAgent.train_offline = timed("dqn", saved[1])
    DQNAgent.imitate = timed("imitation", saved[2])
    try:
        yield clocks
    finally:
        traces.fit, DQNAgent.train_offline, DQNAgent.imitate = saved


def pretraining_prime(torch, records, tree, state, deploy_vec, out):
    """``prime_allocator`` of a hybrid run: the allocator takes the
    full-width deployment vector and the one set of DNN weights, then
    ``pretrain_on_trace(alloc, records)`` at the reference's defaults, each
    phase timed; its pretrained state goes into ``out`` (losses, clocks,
    weights and target as numpy trees, BatchNorm state, generator state,
    Q-values on the trace's states), and every decision is logged."""
    import numpy as np
    from repro_torch.core.dnn.traces import pretrain_on_trace, replay_streams
    from test_torch_checks import decision_log

    def prime(alloc):
        alloc.deploy_vec = np.array(deploy_vec, copy=True)
        alloc.agent.load_reference(tree, state)
        with timed_pretrain(torch, {}) as clocks:
            losses = pretrain_on_trace(alloc, records)
        agent = alloc.agent
        snaps = replay_streams(records, alloc.deploy_vec,
                               window=alloc.dnn_cfg.window)
        # copies: on the CPU a parameter's numpy view would follow the
        # live loop's training
        out.update(
            losses=losses, clocks=clocks,
            tree=copy.deepcopy(dnn_tree(agent.net)),
            target=copy.deepcopy(dnn_tree(agent.target)),
            bn={bn: {k: v.cpu().numpy().copy() for k, v in d.items()}
                for bn, d in agent.bn_state.items()},
            rng=agent.rng.bit_generator.state, warmup=agent.cfg.warmup,
            buffer_n=agent.buffer.n, snaps=snaps,
            q=np.stack([agent.q_values(s) for s in snaps]), decisions=[])
        decision_log(alloc, out["decisions"])
    return prime


def flat_tree(tree, prefix=()):
    """A nested dict/list tree → {"a.0.b": array}."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {".".join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, prefix + (str(k),)))
    return out


def param_gaps(a, b):
    """Two flat parameter dicts → ({"determined", "noise"}: max |a - b|,
    the determined leaf with the largest gap)."""
    import numpy as np
    gaps, worst = {"determined": 0.0, "noise": 0.0}, ("", 0.0)
    for name, v in a.items():
        d = np.abs(v - b[name])
        noise = np.zeros(d.shape, bool)
        if name in NOISE_LEAVES:
            noise[...] = True
        elif name == NOISE_ROWS[0]:
            noise[NOISE_ROWS[1]:] = True
        if noise.any():
            gaps["noise"] = max(gaps["noise"], float(d[noise].max()))
        if (~noise).any() and float(d[~noise].max()) > worst[1]:
            worst = (name, float(d[~noise].max()))
    gaps["determined"] = worst[1]
    return gaps, worst[0]


def pretrain_agreement(card, cpu, label, exact):
    """Card against CPU after ``pretrain_on_trace``: the schedule equal
    (phase lengths, transitions, replay and shuffle draws, warmup, buffer);
    the first loss (before any step) within PRETRAIN_TOL; the parameters
    after each phase and the target net compared.  ``exact``: every loss,
    parameter, target parameter and BatchNorm statistic within
    PRETRAIN_TOL.  As the path runs: the noise-driven elements within
    AdamW's step bound summed over the phases, the other gaps printed (the
    noise reaches the trunk through bn2's ReLU)."""
    import numpy as np
    phases = ("supervised", "dqn", "imitation")
    for phase in phases:
        check(len(card["losses"][phase]) == len(cpu["losses"][phase]) > 0,
              f"{label}: {phase} took {len(card['losses'][phase])} steps "
              f"on the card, {len(cpu['losses'][phase])} on the CPU")
    check(card["losses"]["transitions"] == cpu["losses"]["transitions"]
          and card["rng"] == cpu["rng"] and card["warmup"] == cpu["warmup"]
          and card["buffer_n"] == cpu["buffer_n"],
          f"{label}: the schedules differ (transitions, draws, warmup)")
    first = abs(card["losses"]["supervised"][0]
                - cpu["losses"]["supervised"][0])
    check(first <= PRETRAIN_TOL, f"{label}: first supervised loss, card vs "
                                 f"CPU, differs by {first}")
    loss_err = {phase: float(np.abs(np.subtract(
        card["losses"][phase], cpu["losses"][phase])).max())
        for phase in phases}
    bound = 2 * 1.2 * PRETRAIN_LR_STEPS
    after = {phase: param_gaps(card["clocks"]["after"][phase],
                               cpu["clocks"]["after"][phase])
             for phase in phases}
    after["target"] = param_gaps(flat_tree(card["target"]),
                                 flat_tree(cpu["target"]))
    noise = max(g["noise"] for g, _ in after.values())
    determined = max(g["determined"] for g, _ in after.values())
    bn_err = max(float(np.abs(card["bn"][bn][k] - cpu["bn"][bn][k]).max())
                 for bn in card["bn"] for k in card["bn"][bn])
    gaps_text = "; ".join(
        f"after {k} {g['determined']:.3g} ({leaf or '-'}), noise-driven "
        f"{g['noise']:.3g}" for k, (g, leaf) in after.items())
    if exact:
        check(max(loss_err.values()) <= PRETRAIN_TOL,
              f"{label}: losses, card vs CPU, max |err| {loss_err}")
        check(max(determined, noise, bn_err) <= PRETRAIN_TOL,
              f"{label}: parameters, card vs CPU: {gaps_text}; BatchNorm "
              f"state {bn_err}")
    check(noise <= PRETRAIN_TOL + bound,
          f"{label}: the noise-driven elements moved apart by {noise}, "
          f"past AdamW's bound {bound}")
    print(f"  {label}: pretrain_on_trace (20 epochs, 60 DQN steps, 30 "
          f"imitation epochs; {card['losses']['transitions']} transitions) "
          f"card vs CPU: loss curves max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in loss_err.items())
          + f"; parameters (max |err|, worst leaf) {gaps_text} (bound "
          f"{PRETRAIN_TOL + bound:.3g}); BatchNorm state {bn_err:.3g}; "
          f"first loss {first:.3g}; schedule and draws equal")
    for dev, run in (("card", card), ("CPU", cpu)):
        c, ls = run["clocks"], run["losses"]
        print(f"    {dev}: " + ", ".join(
            f"{k} {c[k] * 1e3:.1f} ms ({len(ls[k])} steps, loss "
            f"{ls[k][0]:.4f} -> {ls[k][-1]:.4f})" for k in phases)
            + " (host clock)")


def hybrid_agreement(card, cpu, card_logs, cpu_logs, label, held):
    """The card's hybrid TickLogs against the CPU's: equal up to the first
    tick whose decision margin, on either device, is under MARGIN_FACTOR x
    the largest card/CPU Q gap on the trace's states at the pretrained
    weights; a divergence before it fails.  ``held``: that cutoff must
    come after tick 0 (else the rule holds nothing), and learn_loss must
    stay within PRETRAIN_TOL of its size (at least 1) while the
    trajectories are equal: the live TD losses after pretraining reach
    tens, and evaluation-mode BatchNorm amplifies rounding there
    (``test_torch_orchestration`` holds the reference against the port at
    one set of pretrained weights to the same rule).  Not ``held``, the
    comparison is only printed."""
    import numpy as np
    from test_torch_checks import MARGIN_FACTOR, decision_margin
    gap = float(np.abs(card["q"] - cpu["q"]).max())
    margins = [(decision_margin(*a), decision_margin(*b))
               for a, b in zip(card["decisions"], cpu["decisions"])]
    check(len(margins) == len(card_logs) == len(cpu_logs),
          f"{label}: {len(margins)} decisions logged for "
          f"{len(card_logs)} ticks")
    cutoff = next((i for i, m in enumerate(margins)
                   if min(m) < MARGIN_FACTOR * gap), len(margins))
    got, want = trajectory(card_logs), trajectory(cpu_logs)
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    at = (f"tick {cutoff} (margins card {margins[cutoff][0]:.3g}, CPU "
          f"{margins[cutoff][1]:.3g})" if cutoff < len(margins)
          else "no tick")
    if held:
        check(cutoff > 0, f"{label}: the margin rule holds no tick: the "
                          f"card/CPU Q gap {gap} puts its cutoff at {at}")
    if diff is not None and diff < cutoff:
        raise SmokeFailure(f"{label}: the card's TickLogs differ from the "
                           f"CPU's at tick {diff}, before the margin cutoff "
                           f"at {at}: {got[diff]} vs {want[diff]}")
    equal = len(got) if diff is None else diff
    loss_err, loss_rel, loss_max = 0.0, 0.0, 0.0
    for a, b in zip(card_logs[:equal], cpu_logs[:equal]):
        check((a.learn_loss is None) == (b.learn_loss is None),
              f"{label}: tick {a.tick} trained on one device only")
        if a.learn_loss is not None:
            err = abs(a.learn_loss - b.learn_loss)
            loss_err = max(loss_err, err)
            loss_rel = max(loss_rel, err / max(1.0, abs(b.learn_loss)))
            loss_max = max(loss_max, abs(b.learn_loss))
    if held:
        check(loss_rel <= PRETRAIN_TOL, f"{label}: learn_loss, card vs CPU, "
                                        f"max |err| {loss_err} (relative "
                                        f"{loss_rel}) at losses up to "
                                        f"{loss_max}")
    n_dqn = [sum(t.reason.startswith("dqn:") for t in logs)
             for logs in (card_logs, cpu_logs)]
    print(f"  {label}{'' if held else ' (printed, not held)'}: Q gap on "
          f"the trace's {len(card['q'])} states {gap:.3g}; the margin falls "
          f"under {MARGIN_FACTOR:g} x the gap at {at}; TickLogs equal "
          + (f"through all {len(got)} ticks" if diff is None
             else f"through tick {diff - 1}, first difference tick {diff}")
          + f"; learn_loss max |err| {loss_err:.3g} (relative "
          f"{loss_rel:.3g}, losses up to {loss_max:.3g}) while equal; Q "
          f"up to {float(np.abs(card['q']).max()):.3g}; DQN decided "
          f"{n_dqn[0]} ticks on the card, {n_dqn[1]} on the CPU")
    return dict(gap=gap, cutoff=cutoff, diff=diff, n_dqn=n_dqn,
                loss_err=loss_err)


def importance_phase(torch, tree, state, records, deploy_vec, lc, seed):
    """``permutation_importance`` on the trace's ``supervised_dataset``
    with the card-pretrained weights, on the card and on the CPU: each
    group's raw increase within PRETRAIN_TOL."""
    from repro_torch.core.dnn import train
    from repro_torch.core.dnn.model import DNNConfig, dnn_from_reference
    from repro_torch.core.dnn.traces import supervised_dataset
    from test_torch_checks import raw_importance
    cfg = DNNConfig()
    ds = supervised_dataset(
        records, deploy_vec, window=cfg.window, slo_ms=lc.slo_ms,
        model_params_b=float(10.0 ** (2.0 * deploy_vec[0])))
    raw, clocks = {}, {}
    for dev in ("cuda", "cpu"):
        net, st = dnn_from_reference(tree, state, cfg, device=dev)
        t0 = time.perf_counter()
        raw[dev] = raw_importance(train._eval_loss, train.FEATURE_GROUPS,
                                  net, st, ds, seed=seed)
        clocks[dev] = time.perf_counter() - t0
    err = max(abs(raw["cuda"][k] - raw["cpu"][k]) for k in raw["cpu"])
    check(err <= PRETRAIN_TOL, f"permutation importance, card vs CPU: max "
                               f"|err| {err}: {raw}")
    total = sum(raw["cuda"].values()) or 1.0
    print(f"  permutation importance ({len(ds['alloc_target'])} rows, "
          f"card-pretrained weights), raw increase of the evaluation loss "
          f"on the card: "
          + ", ".join(f"{k} {v:.4g} ({v / total:.0%})"
                      for k, v in raw["cuda"].items())
          + f"; card vs CPU max |err| {err:.3g}; host clock card "
          f"{clocks['cuda'] * 1e3:.1f} ms, CPU {clocks['cpu'] * 1e3:.1f} ms")


def selector_phase(tree, state, records, snaps, cfg, lc):
    """``DNNSelector`` over the card-pretrained agent, on the card and on
    the CPU (the same weights bridged), over each recorded tick's operating
    point as ``traces._strategy_label`` reads it: the strategy head decides
    from the first context (``min_trained=1``; the default gate, 64, is
    longer than the trace).  Logits within PRETRAIN_TOL of their size (at
    least 1), choices equal: one-deployment training drives the deployment
    stream's running variance toward 0, so evaluation mode multiplies each
    device's rounding of x - running mean by up to 1/sqrt(eps) = 316
    (``test_torch_orchestration`` holds the reference against the port at
    one set of such weights to the same rule).
    → (the card's choice at the last tick, the CPU's)."""
    import numpy as np
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn.model import DNNConfig
    from repro_torch.core.orchestration import (
        STRATEGY_NAMES, DeploymentContext, DNNSelector,
    )
    choices, logits, labels = {}, {}, {}
    for dev in ("cuda", "cpu"):
        agent = DQNAgent(DNNConfig(), device=dev)
        agent.load_reference(tree, state)
        sel = DNNSelector(agent, None, min_trained=1)
        choices[dev], logits[dev] = [], []
        for rec, s in zip(records, snaps):
            ctx = DeploymentContext(
                model_params_b=cfg.n_params() / 1e9,
                traffic_rps=float(rec.get("rps", 0.0)), slo_ms=lc.slo_ms,
                error_budget=0.01,
                spare_capacity_frac=max(1.0 - float(rec.get("flop_util",
                                                            0.0)), 0.0),
                cost_sensitivity=0.5, is_critical=True,
                transport_ms=float(rec.get("transport_ms", 0.0)))
            choices[dev].append(sel.select(ctx, s))
            logits[dev].append(sel.strategy_logits(s))
        labels[dev] = [STRATEGY_NAMES[i] for _, i in sel.labels]
    want = np.stack(logits["cpu"])
    diff = np.abs(np.stack(logits["cuda"]) - want)
    err = float(diff.max())
    rel = float((diff / np.maximum(1.0, np.abs(want))).max())
    check(rel <= PRETRAIN_TOL, f"strategy logits, card vs CPU: max |err| "
                               f"{err} (relative {rel})")
    check(choices["cuda"] == choices["cpu"],
          f"strategy choices differ: card {choices['cuda']}, CPU "
          f"{choices['cpu']}")
    print(f"  DNNSelector (card-pretrained head, min_trained=1) over the "
          f"{len(records)} recorded ticks: logits up to "
          f"{float(np.abs(want).max()):.3g}, card vs CPU max |err| "
          f"{err:.3g} (relative {rel:.3g}), choices equal: {choices['cuda']}; "
          f"the tree's: {labels['cuda']}")
    return choices["cuda"][-1], choices["cpu"][-1]


def canary_sample(logs):
    """A CanarySample of a loop run: its ticks' p50 and p95 latencies on
    the virtual clock (ticks that finished requests), every finished
    request, no errors (the in-process replicas drop nothing), and the
    mean slot utilization of its replica reports."""
    import numpy as np
    from repro_torch.core.orchestration import CanarySample
    served = [t for t in logs if t.served]
    utils = [u for t in logs for _, u in t.replica_util]
    return CanarySample(
        latencies_ms=np.asarray([x for t in served
                                 for x in (t.latency_p50_ms,
                                           t.latency_p95_ms)]),
        n_requests=sum(t.served for t in logs), n_errors=0,
        utilization=float(np.mean(utils)) if utils else 0.0)


def host_to_card(torch, nbytes, reps=3):
    """(GB/s, ms) of copying ``nbytes`` from pinned host memory to the
    card, median of ``reps`` copies timed by CUDA events."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dev.copy_(host, non_blocking=True)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    del host, dev
    ms = statistics.median(times)
    return nbytes / (ms * 1e-3) / 1e9, ms


def rollout_phase(torch, cfg, lc, strategies, hybrid_logs, planner_logs,
                  card):
    """``RolloutManager`` for the chosen strategy: ``DeployEnv`` with
    qwen2.5-3b's bf16 weights, one device a replica, ``lc.max_replicas``
    replicas, ``hbm_fill_gbps`` measured; each soak tick fed the hybrid
    run's sample (canary) against the planner run's (control).  The
    phase sequence and ``elapsed_s`` of the card's choice must equal the
    CPU choice's on the same samples."""
    from repro_torch.core.orchestration import (
        DeployEnv, Phase, RolloutManager, total_deploy_seconds, CATALOG,
    )
    nbytes = cfg.n_params() * 2
    gbps, ms = host_to_card(torch, nbytes)
    print(f"  host -> card copy of qwen2.5-3b's bf16 weights "
          f"({nbytes / 1e9:.3f} GB, pinned): {ms:.2f} ms, {gbps:.2f} GB/s "
          f"({card})")
    env = DeployEnv(params_bytes=nbytes, chips_per_replica=1,
                    n_replicas=lc.max_replicas, hbm_fill_gbps=gbps)
    canary, control = canary_sample(hybrid_logs), canary_sample(planner_logs)
    runs = []
    for strategy in strategies:
        mgr = RolloutManager(strategy, env)
        seq = [(mgr.start().phase.value, mgr.state.traffic_frac,
                mgr.state.elapsed_s)]
        for _ in range(ROLLOUT_TICKS):
            if mgr.state.phase in (Phase.COMPLETED, Phase.ROLLED_BACK):
                break
            s = mgr.tick(canary, control)
            seq.append((s.phase.value, s.traffic_frac, s.elapsed_s))
        runs.append((seq, mgr.state.health_log))
    check(runs[0][0] == runs[1][0], f"rollout differs: card {runs[0][0]}, "
                                    f"CPU {runs[1][0]}")
    seq, health = runs[0]
    check(seq[-1][0] in ("completed", "rolled_back"),
          f"the rollout did not end in {ROLLOUT_TICKS} ticks: {seq}")
    verdicts = [(round(v["latency_p"], 4), v["healthy"]) for v in health]
    print(f"  rollout {strategies[0]} (healthy model time "
          f"{total_deploy_seconds(CATALOG[strategies[0]], env):.1f} s): "
          f"canary p50/p95 mean {canary.latencies_ms.mean():.0f} ms over "
          f"{canary.n_requests} requests, control "
          f"{control.latencies_ms.mean():.0f} ms over {control.n_requests}; "
          f"phases " + " -> ".join(f"{p}@{f:g}" for p, f, _ in seq)
          + f", elapsed_s {seq[-1][2]:.3f}; verdicts (latency p, healthy) "
          f"{verdicts}; equal to the CPU's")


def learning_phase(torch, ops, seed, add, loop):
    """Phase 7: the paper's offline learning and deployment orchestration
    through the port, card against CPU, on the planner trace phase 6
    recorded (see the module docstring)."""
    import dataclasses
    from repro_torch.core.dnn.model import DNNConfig, MultiStreamDNN
    from repro_torch.serving.closed_loop import run_closed_loop
    from test_torch_checks import exact_deploy_stream
    cfg, smoke, lc = loop["cfg"], loop["smoke"], loop["lc"]
    card = gpu_line()
    t0 = time.perf_counter()
    print(f"[7] offline learning and orchestration on the planner trace: "
          f"pretrain_on_trace, the hybrid loop, importance, strategy "
          f"selection and a canary rollout ({card})")
    card_trace, cpu_trace = loop["card_trace"], loop["cpu_trace"]
    first = next((i for i, (a, b) in enumerate(zip(card_trace, cpu_trace))
                  if a != b), None)
    check(len(card_trace) == len(cpu_trace) == LOOP_TICKS and first is None,
          f"the card's planner trace ({len(card_trace)} records) differs "
          f"from the CPU smoke run's at tick {first}")
    print(f"  the card's planner trace equals the CPU smoke run's: "
          f"{len(card_trace)} records of {len(card_trace[0])} fields, every "
          f"field equal (none reads the host clock: the loop runs on its "
          f"virtual clock)")
    src = MultiStreamDNN(DNNConfig(), seed=seed, device="cpu")
    tree = dnn_tree(src)
    state = {bn: {k: v.numpy() for k, v in d.items()}
             for bn, d in src.init_state().items()}
    deploy = loop["planner"]["alloc"].deploy_vec
    hybrid_lc = dataclasses.replace(lc, alloc_mode="hybrid")
    runs = {name: {} for name in ("card", "cpu", "card_exact", "cpu_exact")}
    # the main path: the hybrid loop over full-width replicas, primed by
    # pretrain_on_trace on the card
    hybrid = loop_run(torch, ops, cfg, hybrid_lc, "hybrid, pretrained on "
                      "the planner trace", seed,
                      prime=pretraining_prime(torch, card_trace, tree, state,
                                              deploy, runs["card"]))
    add(hybrid["counts"])
    traj = [1] + [t.replicas for t in hybrid["logs"]]
    print(f"  replica trajectory: {traj} (planner: "
          f"{[1] + [t.replicas for t in loop['planner']['logs']]})")
    free(torch)
    # the pair again with identical rows computed exactly: the same
    # full-width loop on the card, its launches checked but not added
    with exact_deploy_stream():
        exact_run = loop_run(torch, ops, cfg, hybrid_lc, "hybrid, exact "
                             "deployment stream", seed,
                             prime=pretraining_prime(torch, card_trace, tree,
                                                     state, deploy,
                                                     runs["card_exact"]))
    free(torch)
    logs = {"card": hybrid["logs"], "card_exact": exact_run["logs"]}
    t1 = time.perf_counter()
    for name, exact in (("cpu", False), ("cpu_exact", True)):
        with exact_deploy_stream() if exact else contextlib.nullcontext():
            router, logs[name] = run_closed_loop(
                smoke, autoscale=True, ticks=LOOP_TICKS, seed=seed,
                lc=hybrid_lc, device="cpu",
                prime_allocator=pretraining_prime(
                    torch, cpu_trace, tree, state, deploy, runs[name]))
            router.close()
    print(f"  the CPU's hybrid runs, as the path runs and with the exact "
          f"deployment stream, at smoke width (vocab {smoke.vocab}): "
          f"{time.perf_counter() - t1:.1f} s")
    pretrain_agreement(runs["card"], runs["cpu"], "as the path runs", False)
    pretrain_agreement(runs["card_exact"], runs["cpu_exact"],
                       "exact deployment stream", True)
    hybrid_agreement(runs["card"], runs["cpu"], logs["card"], logs["cpu"],
                     "hybrid loop as the path runs, card full width vs CPU "
                     "smoke", False)
    hybrid_agreement(runs["card_exact"], runs["cpu_exact"],
                     logs["card_exact"], logs["cpu_exact"],
                     "hybrid loop, exact deployment stream, card full width "
                     "vs CPU smoke", True)
    importance_phase(torch, runs["card"]["tree"], runs["card"]["bn"],
                     card_trace, deploy, lc, seed)
    choice = selector_phase(runs["card"]["tree"], runs["card"]["bn"],
                            card_trace, runs["card"]["snaps"], cfg, lc)
    rollout_phase(torch, cfg, lc, choice, logs["card"],
                  loop["planner"]["logs"], card)
    print(f"  offline learning and orchestration: "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 8
# the remote fleet: phase 6's dense loop over worker processes, each serving
# full-width qwen2.5-3b on the card; the memory of the fleet at its peak of
# LoopConfig().max_replicas workers
FLEET_WORKERS = 4              # LoopConfig().max_replicas
FLEET_STDERR_TAIL = 40


def compute_apps() -> list[tuple[int | None, str]]:
    """(pid, used memory) of every process nvidia-smi sees on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, _, mem = (x.strip() for x in line.partition(","))
        apps.append((int(pid) if pid.isdigit() else None, mem))
    return apps


@contextlib.contextmanager
def worker_processes(out_dir: Path):
    """Track every worker process the port spawns in the block (their
    ``Popen`` handles, in spawn order), send the workers' stderr (and this
    process's) to ``out_dir/stderr.txt``, and have each worker write its
    kernel launch counts and peak device memory into ``out_dir``.  Every
    worker still alive at the end is killed, whatever happened."""
    from repro_torch.serving.worker import STATS_ENV
    spawned = []
    popen = subprocess.Popen

    class Tracked(popen):
        def __init__(self, args, *a, **k):
            super().__init__(args, *a, **k)
            if "repro_torch.serving.worker" in args:
                spawned.append(self)

    out_dir.mkdir(parents=True, exist_ok=True)
    sys.stderr.flush()
    saved = os.dup(2)
    err = open(out_dir / "stderr.txt", "w")
    os.dup2(err.fileno(), 2)
    os.environ[STATS_ENV] = str(out_dir)
    subprocess.Popen = Tracked
    try:
        yield spawned
    finally:
        subprocess.Popen = popen
        del os.environ[STATS_ENV]
        for proc in spawned:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        err.close()


def worker_stats(out_dir: Path, pids, timeout_s=60.0):
    """→ (the kernel launch counts the workers ``pids`` wrote when their
    sessions ended, summed; {pid: peak allocated device bytes}); waits for
    each worker's file."""
    deadline = time.monotonic() + timeout_s
    total, peaks = {}, {}
    for pid in pids:
        path = out_dir / f"stats-{pid}.json"
        while not path.exists():
            check(time.monotonic() < deadline,
                  f"worker {pid} wrote no launch counts")
            time.sleep(0.1)
        stats = json.loads(path.read_text())
        for name, n in stats["launches"].items():
            total[name] = total.get(name, 0) + n
        peaks[pid] = stats["device_peak_bytes"]
    return total, peaks


def fleet_memory(torch, spawned, label) -> dict:
    """The fleet at its peak: 4 distinct live worker PIDs, none this
    process's, and nvidia-smi's compute apps — the 4 workers and this
    process, each worker by its PID where nvidia-smi sees this process's
    PID namespace (in a container it may list every process as pid 1 with
    the card's total) — beside the card's used memory from this process's
    view."""
    live = [p.pid for p in spawned if p.poll() is None]
    apps = compute_apps()
    free_b, total_b = torch.cuda.mem_get_info()
    listed = [pid for pid, _ in apps]
    print(f"    {label} at {len(live)} live workers: nvidia-smi compute "
          f"apps (pid, used memory) {apps}; this process pid "
          f"{os.getpid()}; workers {live}; card used "
          f"{(total_b - free_b) / 2**30:.2f} GiB of {total_b / 2**30:.2f}")
    check(len(set(live)) == FLEET_WORKERS and os.getpid() not in live,
          f"{label}: {len(live)} live workers at the peak, expected "
          f"{FLEET_WORKERS} distinct from this process")
    check(len(apps) == FLEET_WORKERS + 1,
          f"{label}: nvidia-smi lists {len(apps)} processes on the card, "
          f"expected the {FLEET_WORKERS} workers and this process")
    if set(live) & set(listed):
        check(set(live) <= set(listed), f"{label}: workers "
              f"{sorted(set(live) - set(listed))} are not on the card")
    else:
        print(f"      nvidia-smi lists PIDs of another namespace "
              f"({sorted(set(listed))}): the workers are told apart by "
              f"count; their peaks follow from their own stats")
    return {"apps": apps, "used_bytes": total_b - free_b}


def fleet_run(torch, ops, cfg, lc, label, seed, spawned, phase6,
              setup_s=0.0):
    """One closed loop over worker processes: run_closed_loop as phase 6
    runs it, the router's steps timed; the TickLogs' decisions and served
    counts and every finished stream held to phase 6's dense in-process
    run, the workers' launch counts summed and held to phase 6's, the
    fleet's memory at its peak read, and no worker left afterwards."""
    from repro_torch.serving.closed_loop import run_closed_loop
    from repro_torch.serving.replica import SocketReplica
    sink, marks, steps, handshakes, peak = [], [], [], [], {}
    rpc = SocketReplica._rpc

    def timed_rpc(self, msg, *, timeout=None):
        t = time.perf_counter()
        out = rpc(self, msg, timeout=timeout)
        if msg["op"] in ("attach", "init"):
            handshakes.append((self.replica_id, msg["op"],
                               time.perf_counter() - t))
        return out

    def hook(tick, router, collector):
        marks.append((time.perf_counter(), len(steps)))
        if not peak and router.replica_count == FLEET_WORKERS:
            peak.update(fleet_memory(torch, spawned, label))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    SocketReplica._rpc = timed_rpc
    try:
        with timed_router_steps(torch, steps):
            router, logs = run_closed_loop(
                cfg, autoscale=True, ticks=LOOP_TICKS, seed=seed, lc=lc,
                sink=sink, chaos_hook=hook, device="cuda")
    finally:
        SocketReplica._rpc = rpc
    wall = time.perf_counter() - t0
    try:
        for t in logs:
            print("      " + tick_line(t))
        m = router.metrics()
        check(m["completed"] == len(sink) > 0,
              f"{label}: {m['completed']} completed, {len(sink)} in the sink")
        check(peak, f"{label}: the loop never reached {FLEET_WORKERS} "
                    f"replicas")
        want = [(t.replicas, t.reason, t.served) for t in phase6["logs"]]
        got = [(t.replicas, t.reason, t.served) for t in logs]
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        check(len(got) == len(want) and diff is None,
              f"{label}: tick {diff} (replicas, reason, served) "
              f"{got[diff] if diff is not None else ''} vs phase 6's "
              f"{want[diff] if diff is not None else ''}")
        streams = {r.rid: list(r.tokens_out) for r in sink}
        differ = sorted(rid for rid in set(streams) | set(phase6["streams"])
                        if streams.get(rid) != phase6["streams"].get(rid))
        check(not differ, f"{label}: streams differ from phase 6's for "
                          f"requests {differ[:10]}")
        observed = logs[-1].observed
        if lc.observe_addrs:
            rep0 = next(r for r in router.all_replicas if r.replica_id == 0)
            mine, theirs = rep0.lifetime(), observed[0]["lifetime"]
            for key in ("total_completed", "total_tokens"):
                check(theirs[key] == mine[key],
                      f"{label}: the observer's {key} {theirs[key]} != "
                      f"the router's {mine[key]}")
            print(f"    observer on {observed[0]['addr']}: "
                  f"total_completed {theirs['total_completed']}, "
                  f"total_tokens {theirs['total_tokens']}, equal to "
                  f"replica 0's lifetime() through the router")
        check(m["off_list_spawns"] == 0,
              f"{label}: {m['off_list_spawns']} off-list spawns")
        per_rep = {r.replica_id: r.transport_ms for r in router.all_replicas}
        parent = ops.launch_counts()
    finally:
        router.close()
    step_s, ctrl_s = tick_clocks(
        t0, marks, steps,
        {0} | set(range(LOOP_PROFILED[0], LOOP_PROFILED[1] + 1)))
    print(f"    {label}: {len(logs)} ticks, {wall:.1f} s with worker "
          f"start and init{f' (fleet start {setup_s:.1f} s before)' if setup_s else ''}; "
          f"{m['completed']} requests, {m['completed_tokens']} tokens; "
          f"TickLogs' (replicas, reason, served) and all {len(streams)} "
          f"streams equal phase 6's in-process run")
    print(f"    host clock: router step {statistics.mean(step_s) * 1e3:.2f} "
          f"ms mean ({statistics.median(step_s) * 1e3:.2f} median, "
          f"{len(step_s)} steps; phase 6 in process: "
          f"{phase6['step_ms'][0]:.2f} mean, {phase6['step_ms'][1]:.2f} "
          f"median), control tick outside the router steps "
          f"{statistics.mean(ctrl_s) * 1e3:.2f} ms mean (worker starts "
          f"and inits included)")
    print(f"    transport_ms (EWMA of report/lifetime/resume round trips): "
          f"fleet {m['transport_ms']:.3f} ms; per replica "
          f"{ {rid: round(v, 3) for rid, v in per_rep.items()} }; "
          f"rpc_count {m['rpc_count']}")
    for rid in sorted({r for r, _, _ in handshakes}):
        times = {op: dt for r, op, dt in handshakes if r == rid}
        print(f"    replica {rid}: attach {times.get('attach', 0):.2f} s"
              f"{'' if setup_s else ' (the worker process starting)'}, "
              f"init {times.get('init', 0):.2f} s (the engine built on the "
              f"card)")
    check(not any(parent.values()),
          f"{label}: kernels launched in the router's process: {parent}")


def fleet_phase(torch, ops, seed, loop):
    """Phase 8: phase 6's dense closed loop (planner mode, 12 ticks, 1 → 3
    → 4 → 1) over worker processes on the card, at ``topology="proc"``
    (each replica a ``python -m repro_torch.serving.worker <fd> --device
    cuda`` child) and at ``topology="tcp"`` over ``launch_fleet(4,
    device="cuda")`` with a read-only observer on worker 0.  Each run's
    decisions, served counts and streams equal phase 6's in-process run of
    this chip run; its workers' launch counts, summed, equal phase 6's; 4
    distinct worker PIDs hold memory on the card at the peak; no worker
    survives the run; the workers load the kernel library phase 1 built."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import _lib
    from repro_torch.serving.fleet import launch_fleet
    cfg, lc, phase6 = loop["cfg"], loop["lc"], loop["planner"]
    check(lc.max_replicas == FLEET_WORKERS, "LoopConfig() is not 4 replicas")
    print(f"[8] the remote fleet: phase 6's loop over worker processes, "
          f"full-width qwen2.5-3b each, at topology proc and tcp "
          f"({gpu_line()})")
    libs = sorted((p.name, p.stat().st_mtime_ns)
                  for p in _lib.BUILD_DIR.glob("*.so"))
    check(libs, "phase 1 built no kernel library")
    print(f"  this process before the fleet: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="fleet-", dir=_lib.BUILD_DIR))
    for topology in ("proc", "tcp"):
        run_dir = out_dir / topology
        with worker_processes(run_dir) as spawned:
            try:
                label = f"topology {topology}"
                if topology == "proc":
                    fleet_run(torch, ops, cfg,
                              dataclasses.replace(lc, topology="proc"),
                              label, seed, spawned, phase6)
                    # each worker wrote its counts before answering the
                    # router's shutdown
                    for proc in spawned:
                        proc.wait(timeout=60)
                    counts, peaks = worker_stats(run_dir,
                                                 [p.pid for p in spawned])
                else:
                    t1 = time.perf_counter()
                    fleet = launch_fleet(FLEET_WORKERS, device="cuda")
                    setup = time.perf_counter() - t1
                    try:
                        fleet_run(torch, ops, cfg, dataclasses.replace(
                            lc, topology="tcp", addrs=tuple(fleet.addrs),
                            observe_addrs=(fleet.addrs[0],)), label, seed,
                            spawned, phase6, setup_s=setup)
                        # the sessions ended with the router: each worker
                        # writes its counts before the stand-in scheduler
                        # stops it
                        counts, peaks = worker_stats(
                            run_dir, [p.pid for p in spawned])
                    finally:
                        fleet.close()
                check(counts == phase6["counts"],
                      f"{label}: the workers' launch counts {counts} != "
                      f"phase 6's {phase6['counts']}")
                check(all(peaks.values()),
                      f"{label}: a worker never used the card: {peaks}")
                print(f"    {label}: the workers' launch counts, summed over "
                      f"{len(spawned)} workers, equal phase 6's: "
                      f"{ {k: v for k, v in counts.items() if v} }; each "
                      f"worker's peak device memory (its own "
                      f"max_memory_allocated): "
                      f"{ {pid: round(b / 2**30, 2) for pid, b in peaks.items()} } GiB")
                alive = [p.pid for p in spawned if p.poll() is None]
                check(not alive, f"{label}: workers {alive} outlived the "
                                 f"router")
                # nvidia-smi's list back to this process alone (it may name
                # every process pid 1: count them)
                deadline = time.monotonic() + 30
                while len(apps := compute_apps()) > 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.5)
                check(len(apps) == 1, f"{label}: nvidia-smi still lists "
                                      f"{apps} after the run")
            except Exception as e:
                codes = [(p.pid, p.poll()) for p in spawned]
                sys.stderr.flush()
                tail = (run_dir / "stderr.txt").read_text().splitlines()
                print(f"  {label} FAILED: {e!r}; workers (pid, exit code): "
                      f"{codes}; stderr tail:")
                for line in tail[-FLEET_STDERR_TAIL:]:
                    print(f"    | {line}")
                if isinstance(e, SmokeFailure):
                    raise
                raise SmokeFailure(f"{label}: {e!r}") from e
        tail = (run_dir / "stderr.txt").read_text().splitlines()
        print(f"    {label}: no worker left ({len(spawned)} spawned; "
              f"nvidia-smi lists this process alone); "
              f"worker stderr {len(tail)} lines"
              + "".join(f"\n    | {line}" for line in tail[-10:]))
    check(libs == sorted((p.name, p.stat().st_mtime_ns)
                         for p in _lib.BUILD_DIR.glob("*.so")),
          "the workers rebuilt the kernel library")
    print(f"  the workers loaded the library phase 1 built ({libs[0][0]}), "
          f"rebuilding nothing; remote fleet: "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 9

# the tiny families of tests/conftest.py, rebuilt without JAX (float32)
TINY_BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                 vocab=64, param_dtype="float32", dtype="float32")
TRAIN_TOL = 1e-4
# full width: qwen2.5-3b, 4 steps of 2 x 256 tokens (the run's time limit),
# at the launcher's
# default lr (printed) and then at 3e-5 (held: the loss falls).  At 3e-4,
# constant and without warmup, the 36-layer model overshoots: its loss
# swings by nats from step to step, in bf16 and in float32 compute alike,
# and need not end below its start (PERF.md §6)
FULL_TRAIN_STEPS = 4
FULL_TRAIN = ["--arch", "qwen2.5-3b", "--steps", str(FULL_TRAIN_STEPS),
              "--batch", "2",
              "--seq", "256", "--seed", "0", "--device", "cuda"]
FULL_TRAIN_LRS = (3e-4, 3e-5)
# the training peaks (GiB) phases 9 and 13 measure, under the configs'
# remat ("full"), for phase 15 (c)
TRAIN_PEAKS: dict = {}
SMOKE_TRAIN = ["--arch", "qwen2.5-3b", "--smoke", "--seq", "32", "--batch",
               "2", "--device", "cuda"]


def tiny_configs():
    from repro_torch.models.config import (
        HybridCfg, ModelConfig, MoECfg, SSMCfg,
    )

    def tiny(family, **kw):
        return ModelConfig(**{"name": f"tiny-{family}", "family": family,
                              **TINY_BASE, **kw})

    return {
        "dense": tiny("dense", qkv_bias=True),
        "swa": tiny("dense", sliding_window=8),
        "vlm": tiny("vlm", m_rope=True, m_rope_sections=(2, 1, 1),
                    n_vision_patches=4),
        "moe": tiny("moe", moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=32,
                                      capacity_factor=4.0)),
        "ssm1": tiny("ssm", n_heads=0, n_kv_heads=0, d_ff=0,
                     ssm=SSMCfg(d_state=4, version=1)),
        "ssm2": tiny("ssm", n_heads=0, n_kv_heads=0, d_ff=0,
                     ssm=SSMCfg(d_state=4, version=2, headdim=8)),
        "hybrid": tiny("hybrid", n_heads=4, n_kv_heads=4, d_ff=64,
                       ssm=SSMCfg(d_state=4, version=2, headdim=8),
                       hybrid=HybridCfg(attn_every=2, n_shared_blocks=2)),
        "audio": tiny("audio", enc_dec=True, n_enc_layers=2),
    }


def train_batches(torch, cfg, n, seq=16, seed=3, device="cpu"):
    """n batches of the counted token pipeline, with the family's extras."""
    from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=2, seed=seed))
    return [{k: torch.from_numpy(v).to(device) for k, v in
             extra_inputs(cfg, data.batch(i)).items()} for i in range(n)]


def leaf_gap(torch, got, want) -> float:
    """max |got - want| over max |want| (want all zero: the absolute gap)."""
    top = float(want.abs().max())
    return float((got.cpu() - want).abs().max()) / (top if top > 0 else 1.0)


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def smoke_train_phase(torch, ops):
    """Phase 9.1: each tiny family, one seeded CPU model and its copy on
    the card, the same batches: one step's loss and gradients, 4 AdamW
    steps' losses; then the chunked attention and chunked CE against their
    unchunked forms.  No kernel launches on the train route."""
    from repro_torch.kernels._lib import NoBackwardError
    from repro_torch.models import steps
    from repro_torch.models.attention import Attention
    from repro_torch.models.transformer import LM
    before = ops.launch_counts()
    try:
        for name, cfg in tiny_configs().items():
            cpu = LM(cfg, device="cpu", seed=0)
            card = copy.deepcopy(cpu).to("cuda")
            bs = train_batches(torch, cfg, 4)
            (loss, _), grads = steps.loss_and_grads(cpu, bs[0])
            (gloss, _), ggrads = steps.loss_and_grads(
                card, {k: v.cuda() for k, v in bs[0].items()})
            gaps = {k: leaf_gap(torch, ggrads[k], g) for k, g in grads.items()}
            worst = max(gaps, key=gaps.get)
            step, (opt_init, _) = steps.make_train_step(cfg)
            losses = {}
            for dev, model in (("cpu", cpu), ("cuda", card)):
                state = steps.TrainState(model, opt_init(dict(
                    model.named_parameters())), 0)
                losses[dev] = []
                for b in bs:
                    state, m = step(state, {k: v.to(dev) for k, v in
                                            b.items()})
                    losses[dev].append(float(m["loss"]))
            step_gap = max(rel_gap(a, b) for a, b in
                           zip(losses["cuda"], losses["cpu"]))
            print(f"  {name:6s} loss card {float(gloss):.6f} cpu "
                  f"{float(loss):.6f}; worst gradient leaf {worst} "
                  f"{gaps[worst]:.2e} of its size; 4 AdamW steps' losses "
                  f"within {step_gap:.2e} ({losses['cuda'][-1]:.6f})")
            check(rel_gap(float(gloss), float(loss)) <= TRAIN_TOL,
                  f"{name}: loss card {float(gloss)} vs cpu {float(loss)}")
            check(gaps[worst] <= TRAIN_TOL,
                  f"{name}: gradient {worst} off by {gaps[worst]:.2e}")
            check(step_gap <= TRAIN_TOL,
                  f"{name}: step losses {losses['cuda']} vs {losses['cpu']}")
        # the chunked paths at chunk 16 over 64 tokens, on the card
        g = torch.Generator().manual_seed(5)
        q, k, v = (torch.randn(2, 64, n, 16, generator=g).cuda()
                   .requires_grad_() for n in (4, 2, 2))
        outs = {}
        for chunk in (16, 10**9):
            Attention.CHUNK_Q = chunk
            out = Attention._sdpa_masked(q, k, v, causal=True, window=None)
            outs[chunk] = (out.detach(),) + torch.autograd.grad(
                out.square().sum(), (q, k, v))
        Attention.CHUNK_Q = 1024
        att_gap = max(leaf_gap(torch, a, b.cpu()) for a, b in
                      zip(outs[16], outs[10**9]))
        cfg = tiny_configs()["dense"]
        model = LM(cfg, device="cuda", seed=1)
        b = train_batches(torch, cfg, 1, seq=64, device="cuda")[0]
        params = list(model.parameters())
        for p in params:
            p.requires_grad_()
        h, _ = model(b, train=True, return_hidden=True)
        ce_c = steps.chunked_cross_entropy(model, h, b["labels"], cfg,
                                           chunk=16)
        gc_ = torch.autograd.grad(ce_c, params)
        ce_f = steps.cross_entropy(model(b, train=True)[0], b["labels"])
        gf = torch.autograd.grad(ce_f, params)
        for p in params:
            p.requires_grad_(False)
        ce_gap = max(leaf_gap(torch, a, c.cpu()) for a, c in zip(gc_, gf))
        ce_c, ce_f = float(ce_c.detach()), float(ce_f.detach())
        print(f"  chunked attention (16 of 64 queries) vs unchunked: output "
              f"and gradients within {att_gap:.2e}; chunked CE {ce_c:.7f} "
              f"vs {ce_f:.7f}, gradients within {ce_gap:.2e}")
        check(att_gap <= 1e-5, f"chunked attention off by {att_gap:.2e}")
        check(rel_gap(ce_c, ce_f) <= 1e-6, f"chunked CE {ce_c} vs {ce_f}")
        check(ce_gap <= 1e-5, f"chunked CE gradients off by {ce_gap:.2e}")
    except NoBackwardError as e:
        raise SmokeFailure(f"a kernel ran on the train route: {e}") from e
    finally:
        Attention.CHUNK_Q = 1024
    check(ops.launch_counts() == before,
          f"kernels launched on the train route: {ops.launch_counts()}")


def resume_phase(torch, out_dir: Path):
    """Phase 9.2: the launcher at smoke width on the card, 6 steps with a
    checkpoint every 3, then --resume to 9, against an uninterrupted 9-step
    run: step 9's record and every leaf of step 9's checkpoint."""
    import numpy as np
    from repro_torch.launch import train as train_cli

    def run(tag, argv):
        buf = io.StringIO()
        log = out_dir / f"{tag}.jsonl"
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(SMOKE_TRAIN + argv + ["--log", str(log)])
        check(rc == 0, f"train {tag} exited {rc}")
        return [json.loads(line) for line in log.read_text().splitlines()]

    ck, whole = out_dir / "ck", out_dir / "whole"
    run("first", ["--steps", "6", "--ckpt-dir", str(ck), "--ckpt-every",
                  "3"])
    steps_saved = sorted(int(p.name[5:]) for p in ck.glob("step_*"))
    check(steps_saved == [3, 6], f"checkpoints at {steps_saved}")
    resumed = run("resumed", ["--steps", "9", "--ckpt-dir", str(ck),
                              "--resume"])
    straight = run("straight", ["--steps", "9", "--ckpt-dir", str(whole)])
    a, b = resumed[-1], straight[-1]
    check(a["step"] == b["step"] == 9, f"last records {a} {b}")
    rec_gap = max(rel_gap(a[k], b[k]) for k in a if k not in ("step", "sec"))
    leaves = sorted(p.name for p in (whole / "step_9").glob("*.npy"))
    bitwise, worst = True, 0.0
    for name in leaves:
        x = np.load(ck / "step_9" / name)
        y = np.load(whole / "step_9" / name)
        bitwise &= x.tobytes() == y.tobytes()
        top = float(np.abs(y).max()) or 1.0
        worst = max(worst, float(np.abs(x - y).max()) / top)
    print(f"  resume at smoke width: checkpoints at 3 and 6, resumed to 9: "
          f"step 9's metrics within {rec_gap:.2e} of an uninterrupted run's, "
          f"{len(leaves)} checkpoint leaves within {worst:.2e}; bitwise "
          f"{'equal' if bitwise and rec_gap == 0 else 'not equal'}")
    check(rec_gap <= 1e-6, f"resumed step 9 {a} vs {b}")
    check(worst <= 1e-6, f"resumed checkpoint off by {worst:.2e}")


def full_train_phase(torch, ops, out_dir: Path):
    """Phase 9.3: qwen2.5-3b at full width through the launcher, 4 steps of
    2 x 256 tokens, no kernel launched, every metric finite: first at the
    launcher's default lr 3e-4, printed, then at 3e-5, whose loss must
    fall; the peak memory, the host clock per step and tokens per second
    of each; then one step profiled (forward + backward alone, and the
    whole step)."""
    from repro_torch.launch import train as train_cli
    for lr in FULL_TRAIN_LRS:
        log = out_dir / f"full-{lr}.jsonl"
        args = train_cli.parse_args(FULL_TRAIN + ["--lr", str(lr), "--log",
                                                  str(log)])
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model = train_cli.train(args).params   # the optimizer state goes
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        n_params = sum(p.numel() for p in model.parameters())
        per_step = recs[-1]["sec"] / (recs[-1]["step"] - recs[0]["step"])
        print(f"  full width qwen2.5-3b, lr {lr}: {model.cfg.n_layers} "
              f"layers, {n_params / 1e9:.3f} B parameters "
              f"({model.embed.table.dtype} masters, {model.cfg.cdtype} "
              f"compute): "
              + "; ".join(f"step {r['step']} loss {r['loss']:.4f} "
                          f"grad_norm {r['grad_norm']:.3f}" for r in recs))
        TRAIN_PEAKS[f"9 one device, 2 x 256, lr {lr}"] = peak_gib(torch)
        print(f"    peak {peak_gib(torch):.2f} GiB of "
              f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
              f"; host clock per step after the first {per_step * 1e3:.1f} "
              f"ms, {args.batch * args.seq / per_step:.0f} training tokens/s;"
              f" the launcher {wall:.1f} s with weight init ({gpu_line()})")
        check(recs[0]["step"] == 1 and recs[-1]["step"] == FULL_TRAIN_STEPS,
              f"records at steps {[r['step'] for r in recs]}")
        check(all(math.isfinite(v) for r in recs for v in r.values()),
              f"a metric is not finite: {recs}")
        check(ops.launch_counts() == before,
              f"kernels launched while training: {ops.launch_counts()}")
        if lr != FULL_TRAIN_LRS[-1]:
            del model
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"loss did not fall: {recs[0]['loss']} -> {recs[-1]['loss']}")
    profile_train_step(torch, model, args)
    return model


def profile_train_step(torch, model, args):
    """Device time of one full-width step: ``loss_and_grads`` alone, then
    the whole step (clipping, AdamW leaf by leaf and the recast besides),
    each after a warm call; then the optimizer state is dropped."""
    from repro_torch.models import steps
    from torch.profiler import ProfilerActivity, profile
    step, (opt_init, _) = steps.make_train_step(model.cfg, lr=args.lr)
    state = steps.TrainState(model, opt_init(dict(model.named_parameters())),
                             0)
    b = train_batches(torch, model.cfg, 1, seq=args.seq, seed=args.seed,
                      device="cuda")[0]
    out = {}
    for label in ("forward + backward", "whole step"):
        run = ((lambda: steps.loss_and_grads(model, b))
               if label == "forward + backward" else
               (lambda: step(state, b)))
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device_ms, _ = report_profile(summed_once(prof), 1)
        launches = sum(e.count for e in prof.key_averages()
                       if e.key == "cudaLaunchKernel")
        out[label] = device_ms
        print(f"    profiled {label}: device busy {device_ms:.1f} ms, "
              f"{launches} kernel launches")
        print_profile(prof, 1, top=6)
    print(f"    clipping, AdamW and the recast: "
          f"{out['whole step'] - out['forward + backward']:.1f} ms of the "
          f"step's {out['whole step']:.1f} ms of device time")
    # the step's floor: the update reads the gradients for their norm, then
    # reads gradients, masters and both moments and writes the masters and
    # moments, all float32 (8 passes); the products are 6 N tokens bf16 ops
    n = sum(p.numel() for p in model.parameters())
    ms, by = bound(8 * 4 * n, 6 * n * args.batch * args.seq, PEAK_BF16_S)
    print(f"    the step's floor {ms:.2f} ms (by {by}: 8 float32 passes over "
          f"{4 * n / 1e9:.2f} GB; {6 * n * args.batch * args.seq / 1e12:.2f}"
          f" TFLOP at the bf16 rate {PEAK_BF16_S / 1e12:.0f} TFLOP/s would "
          f"take {6 * n * args.batch * args.seq / PEAK_BF16_S * 1e3:.2f} ms)")
    del state


def trained_serve_phase(torch, ops, model):
    """Phase 9.4: with the optimizer state freed, recast and serve 4
    requests of 16 tokens through ServingEngine on the trained weights;
    the streams equal a fresh model's loaded with the same parameters."""
    import numpy as np
    from repro_torch.models.transformer import LM
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import EngineCore
    free(torch)
    model.recast()
    cfg = model.cfg
    g = np.random.default_rng(9)
    prompts = [g.integers(0, cfg.vocab, 64 + 8 * i) for i in range(4)]

    def serve(params, counted):
        core = EngineCore(cfg, 256, params=params, device="cuda")
        eng = ServingEngine(cfg, slots=4, max_seq=256, core=core,
                            device="cuda")
        with counted_steps(core) as calls:
            ops.reset_launch_counts()
            streams = run_all(eng, [Request(rid=i, prompt=p, gen_len=16)
                                    for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        if counted:
            check(len(streams) == 4 and all(len(s) == 16 for s in
                                            streams.values()),
                  f"trained model's requests: {streams}")
            check_launches(counts, decoder_launches(cfg.n_layers)(
                calls["fused"], eng.stats.total_admitted), "trained serve")
        return streams, counts

    streams, counts = serve(model, True)
    fresh = LM(cfg, device="cuda", seed=1)
    with torch.no_grad():
        for p, q in zip(fresh.parameters(), model.parameters()):
            p.copy_(q)
    fresh.recast()
    fresh_streams, _ = serve(fresh, False)
    print(f"  served the trained weights: 4 requests of 16 tokens, streams "
          f"{'equal' if streams == fresh_streams else 'NOT equal'} to a "
          f"fresh model's loaded with them")
    check(streams == fresh_streams, "the trained model's streams differ "
          "from a fresh model loaded with its parameters")
    return counts


def train_phase(torch, ops, add):
    """Phase 9: training on the card (see the module docstring)."""
    import shutil
    import tempfile
    from repro_torch.kernels import _lib
    print(f"[9] train: the train route on the card ({gpu_line()})")
    t0 = time.perf_counter()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="train-", dir=_lib.BUILD_DIR))
    try:
        smoke_train_phase(torch, ops)
        resume_phase(torch, out_dir)
        model = full_train_phase(torch, ops, out_dir)
        add(trained_serve_phase(torch, ops, model))
        del model
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    free(torch)
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- phase 10
# the grounding loop: the dry-run at full width and depth, one card's share
# of the reference's decode_32k and prefill_32k cells, for the paper's 1B
# class (h2o-danube-1.8b), qwen2.5-3b and zamba2-2.7b; the roofline DB and
# the queueing model over those cells; the planner sized against them
DRY_ARCHS = ("h2o-danube-1.8b", "qwen2.5-3b", "zamba2-2.7b")
DRY_SHAPES = ("decode_32k", "prefill_32k")
# timed steps after the counted one (one, to keep the whole run inside its
# time limit)
DRY_REPS = 1
# smoke width, card against CPU: the small shapes whose counts must agree
DRY_SMOKE = ((48, 32, "decode"), (40, 32, "prefill"))
PLANNER_RPS = (20.0, 40.0, 80.0, 160.0)


def dry_launches(cfg, kind):
    """One serve step's launch counts, by phase 3's rules: the plain
    decode step samples nothing (no K3)."""
    if cfg.hybrid is not None:
        want = zamba2_launches(*((1, 0) if kind == "decode" else (0, 1)))
    else:
        want = decoder_launches(cfg.n_layers)(
            *((1, 0) if kind == "decode" else (0, 1)), fused=0)
    return {k: v for k, v in {**want, "fused_sample": 0}.items() if v}


def dry_regions(cfg, shape):
    """What each kernel region of one step must record, from the config
    and the cell's shapes alone: a decode step's write instance over the
    whole live ring (the window's for danube) with new rows in the compute
    dtype; a
    prefill's K4 over each prompt (windowed for danube) and, for zamba2,
    its K7 over each Mamba2 layer with one B/C group."""
    import torch
    from repro_torch.kernels import decode_attention, flash_attention, ssm_scan
    from repro_torch.launch.dryrun import replica_batch
    B, S = replica_batch(shape), shape.seq_len
    n_attn = (cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid is not None
              else cfg.n_layers)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    size = torch.empty((), dtype=cfg.cdtype).element_size()
    if shape.kind == "decode":
        ring = min(S, cfg.sliding_window or S)
        per = {"decode_attention_write": (n_attn, decode_attention.cost(
            B, H, KV, hd, B * ring, itemsize=size, new_itemsize=size))}
    else:
        per = {"flash_attention": (n_attn, flash_attention.cost(
            B, S, S, H, KV, hd, window=cfg.sliding_window, itemsize=size))}
        if cfg.ssm is not None:
            per["ssm_scan"] = (cfg.n_layers, ssm_scan.cost(
                B, S, cfg.ssm_heads, cfg.ssm.headdim, cfg.ssm.d_state,
                T=min(cfg.ssm.chunk, ssm_scan.SSD_TILE)))
    return {name: {"calls": n, "flops": n * c.flops, "bytes": n * c.bytes,
                   "transcendentals": n * c.transcendentals}
            for name, (n, c) in per.items()}


def smoke_counts_phase(torch):
    """At smoke width, card against CPU: the same program's counted FLOPs,
    transcendentals, bytes and kernel regions, exactly (on a difference,
    the ops that differ are printed)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.models import ShapeCfg

    def count(cfg, shape, dev):
        _, step, args = build_cell(cfg, shape, dev)
        with CostCounter() as c:
            step(*args)
        return c

    for arch in DRY_ARCHS:
        cfg = get_smoke_config(arch)
        for S, gb, kind in DRY_SMOKE:
            shape = ShapeCfg(f"{kind}_{S}", S, gb, kind)
            card, cpu = count(cfg, shape, "cuda"), count(cfg, shape, "cpu")
            got = (card.flops, card.transcendentals, card.bytes, card.kernels)
            want = (cpu.flops, cpu.transcendentals, cpu.bytes, cpu.kernels)
            if got != want:
                diff = {op: (card.by_op.get(op), cpu.by_op.get(op))
                        for op in set(card.by_op) | set(cpu.by_op)
                        if card.by_op.get(op) != cpu.by_op.get(op)}
                print(f"  {arch} smoke {shape.name}: (calls, FLOPs, "
                      f"transcendentals, bytes) by op, card vs CPU: {diff}")
            check(got == want, f"{arch} smoke {shape.name}: card counts "
                               f"{got} != CPU {want}")
            print(f"  {arch} smoke, {shape.name}: card = CPU, "
                  f"{card.flops} FLOPs, {card.transcendentals} "
                  f"transcendentals, {card.bytes} bytes, kernel regions "
                  f"{sorted(card.kernels)}")


def cost_model_phase(torch, ops, add):
    """Phase 10: the one-card dry-run of six full-width cells into a
    temporary directory, each cell's launches (one step, and the counted
    step plus DRY_REPS timed ones in all, added to the kernels line) and
    kernel regions held to the rules above; the counts at smoke width card
    against CPU; then ``RooflineDB`` over the cells (each read as
    measured), ``ServiceProfile.from_db``, ``examples/quickstart.py``'s part
    3 (a planner-mode ``PredictiveAllocator`` over ``ServingModel
    .latency_util``) on danube's profile, 10 ``ServingModel.tick``s and
    ``ReplicaProfile.from_service`` for zamba2 against qwen."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.allocation.allocator import (
        AllocatorConfig, PredictiveAllocator,
    )
    from repro_torch.core.dnn.features import deploy_vector
    from repro_torch.core.scaling.scaler import ScalingConstraints
    from repro_torch.kernels import _lib
    from repro_torch.launch.dryrun import analyze_cell, cell_path, serve_config
    from repro_torch.models import LM, SHAPES
    from repro_torch.serving.profiles import ReplicaProfile
    from repro_torch.sim import (
        RooflineDB, ServiceProfile, ServingModel, WorkloadSpec,
    )
    print(f"[10] the cost model: one card's share of the dry-run cells at "
          f"full width ({gpu_line()})")
    t0 = time.perf_counter()
    smoke_counts_phase(torch)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun-", dir=_lib.BUILD_DIR))
    try:
        for arch in DRY_ARCHS:
            cfg = get_config(arch)
            params = LM(serve_config(cfg), device="cuda", seed=0)
            for shape_name in DRY_SHAPES:
                shape = SHAPES[shape_name]
                ops.reset_launch_counts()
                rec = analyze_cell(cfg, shape, "cuda", reps=DRY_REPS,
                                   params=params)
                counts = ops.launch_counts()
                cell_path(out_dir, arch, shape_name).write_text(
                    json.dumps(rec, indent=1))
                want = dry_launches(cfg, shape.kind)
                check(rec["launches"] == want,
                      f"{arch} {shape_name}: launches a step "
                      f"{rec['launches']}, expected {want}")
                total = {k: n for k, n in counts.items() if n}
                check(total == {k: (1 + DRY_REPS) * n
                                for k, n in want.items()},
                      f"{arch} {shape_name}: launches {total} over "
                      f"{1 + DRY_REPS} steps")
                add(counts)
                regions = dry_regions(cfg, shape)
                check(rec["kernel_regions"] == regions,
                      f"{arch} {shape_name}: kernel regions "
                      f"{rec['kernel_regions']} != cost(...) {regions}")
                mem = rec["memory"]
                runs = ", ".join(f"{x:.4f}" for x in rec["step_s_runs"])
                print(f"  {arch} {shape_name} x {rec['replica_batch']}: "
                      f"{rec['cost']['flops']:.4e} FLOPs, "
                      f"{rec['cost']['bytes']:.4e} bytes, "
                      f"{rec['cost']['transcendentals']:.4e} "
                      f"transcendentals; step_s {rec['step_s']:.4f} "
                      f"(runs {runs}); "
                      f"launches a step {rec['launches']}; regions = "
                      f"cost(...); arguments "
                      f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, "
                      f"temporaries {mem['temp_size_in_bytes'] / 2**30:.2f} "
                      f"GiB", flush=True)
            del params
            free(torch)
        db = RooflineDB(out_dir)
        for arch in DRY_ARCHS:
            for shape_name in DRY_SHAPES:
                t = db.terms(arch, shape_name, "card")
                rec = json.loads(cell_path(out_dir, arch, shape_name)
                                 .read_text())
                check(t.measured and t.chips == 1
                      and t.flops == rec["cost"]["flops"],
                      f"{arch} {shape_name}: the DB read {t}")
                print(f"  roofline {arch} {shape_name}: compute "
                      f"{t.t_compute * 1e3:.3f} ms, memory "
                      f"{t.t_memory * 1e3:.3f} ms, step_time "
                      f"{t.step_time * 1e3:.3f} ms ({t.bottleneck}); "
                      f"measured step_s {rec['step_s'] * 1e3:.3f} ms = "
                      f"{rec['step_s'] / t.step_time:.2f} x the roofline; "
                      f"peak {t.mem_per_dev / 2**30:.2f} GiB")
        profiles = {arch: ServiceProfile.from_db(db, arch)
                    for arch in DRY_ARCHS}
        for p in profiles.values():
            check(p.chips_per_replica == 1 and p.slots == 8
                  and math.isfinite(p.decode_step_s)
                  and math.isfinite(p.prefill_32k_s),
                  f"ServiceProfile {p}")
            print(f"  profile {p.arch}: {p.slots} slots, decode step "
                  f"{p.decode_step_s * 1e3:.3f} ms, prefill of 32k "
                  f"{p.prefill_32k_s * 1e3:.3f} ms, {p.bottleneck}-bound, "
                  f"{p.tokens_per_s():.0f} tokens/s a replica (roofline)")
        model = ServingModel(profiles["h2o-danube-1.8b"],
                             WorkloadSpec(prompt_len=256, gen_len=12),
                             slo_ms=200.0)
        alloc = PredictiveAllocator(
            model.latency_util, ScalingConstraints(slo_ms=200.0),
            deploy_vector(model_params_b=1.8, family="dense", mesh_model=1,
                          mesh_data=1, region_idx=0, slo_ms=200,
                          cost_weight=0.5),
            cfg=AllocatorConfig(mode="planner"), device="cuda")
        for rps in PLANNER_RPS:
            alloc.observe({"rps": rps})
            d = alloc.decide({"rps": rps, "rps_window": [rps]})
            alloc.apply(d)
            check(d.target_replicas >= 1
                  and math.isfinite(d.predicted_latency_ms),
                  f"planner at {rps} rps: {d}")
            print(f"  planner, load {rps:5.0f} rps -> {d.target_replicas:2d} "
                  f"replicas (pred p95 {d.predicted_latency_ms:.1f} ms, "
                  f"{d.reason})")
        for i in range(10):
            replicas, rps = 1 + i % 3, PLANNER_RPS[i % 4]
            r = model.tick(replicas, rps)
            print(f"  tick {i}: {replicas} replicas at {rps:.0f} rps: served "
                  f"{r.served}, errors {r.errors}, utilization "
                  f"{r.utilization:.3f}, queue {r.queue_depth:.1f}, p95 "
                  f"{np.percentile(r.latency_ms_samples, 95):.1f} ms")
        rp = ReplicaProfile.from_service(profiles["zamba2-2.7b"],
                                         profiles["qwen2.5-3b"])
        check(math.isfinite(rp.speed) and rp.speed > 0, f"{rp}")
        print(f"  ReplicaProfile.from_service(zamba2-2.7b, baseline "
              f"qwen2.5-3b): {rp}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    free(torch)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- phase 11
# the replica fabric: one replica over a device mesh (two shards on the one
# card) and a two-rank pod of worker processes, on phase 3's requests; then
# phase 6's loop over the sharded topology
FABRIC_SHARDS = 2
POD_SIZE = 2
# a sharded tick's rows run at M = 4 where the unsharded tick's run at 8.
# On the H100 the K/V caches stay bitwise equal and the logits agree to the
# float32 readout's rounding (2.7e-6) for 11 decode ticks; at the 12th one
# bf16 rounding in one layer moves the logits by 0.0455, and one request
# whose top two logits were 0.0065 apart parts.  So the sharded replica is
# held to the unsharded one tick by tick, on the rows whose input tokens
# still agree: the first tick's logits within FABRIC_FIRST_GAP; every
# tick's within FABRIC_TICK_GAP, above one rounding's reach and below a
# wrong decode's (whole units); every slot's K/V bitwise equal until a
# row's greedy choice first parts; at most FABRIC_MAX_PARTED rows parting.
FABRIC_FIRST_GAP = 1e-4
FABRIC_TICK_GAP = 0.25
FABRIC_MAX_PARTED = 1


def cli_requests(cfg):
    """Phase 3's requests: the ones ``launch.serve`` draws for ``SERVE``
    (its arrivals drawn first from the same generator), greedy."""
    import numpy as np
    from repro_torch.serving import SamplingParams, synthetic_requests
    from repro_torch.sim.serving import WorkloadSpec
    opts = dict(zip(SERVE[::2], SERVE[1::2]))
    n, seed = int(opts["--requests"]), int(opts["--seed"])
    rng = np.random.default_rng(seed)
    rng.exponential(1.0, n)
    spec = WorkloadSpec(prompt_len=int(opts["--prompt-len"]),
                        gen_len=int(opts["--gen-len"]))
    return synthetic_requests(spec, n, cfg.vocab, rng=rng,
                              sampling=SamplingParams(0.0, 0, seed=seed))


def fabric_run(torch, rep, requests, poll=None):
    """Submit every request at once and step to the end; → (greedy streams
    by request id, host seconds a step, steps).  ``poll()`` runs after
    every step."""
    for r in requests:
        rep.submit(r, now=0.0)
    done, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(done) < len(requests):
        steps += 1
        check(steps < 5000, "the fabric run did not finish")
        done.extend(rep.step(float(steps)))
        if poll is not None:
            poll()
    torch.cuda.synchronize()
    return ({r.rid: list(r.tokens_out) for r in done},
            (time.perf_counter() - t0) / steps, steps)


def sharded_launches(eng, shards, paged):
    """A sharded engine's launch counts: every tick takes the legacy bulk
    path, so per tick each shard launches one K1 (paged: K5) write instance
    per layer and no K3; 36 K4 an admission that ran a prefill."""
    prefilled = eng.stats.total_admitted - eng.lifetime().get(
        "prefix_hits", 0)
    lanes = shards * eng.logits_pulls
    launches = decoder_launches(N_LAYERS)
    if paged:
        return launches(0, prefilled, lanes=lanes, fused=0)
    return launches(lanes, prefilled, fused=0)


def recorded(eng, decode):
    """Route ``eng``'s ticks through ``decode`` (so the legacy bulk path),
    keeping each tick's input tokens and float32 logits on the host."""
    log = []

    def rec(params, tokens, cache):
        logits, cache = decode(params, tokens, cache)
        log.append((tokens[:, 0].cpu(), logits[:, 0].float().cpu()))
        return logits, cache

    eng.decode = rec
    return log


def slot_kv(torch, pool, slot, n):
    """Slot ``slot``'s K and V over its first ``n`` positions in every
    layer, as one (2, layers, n, kv heads, head dim) tensor: the dense
    pool's row, or the paged pool's blocks in its table's order, on the
    shard that owns the slot."""
    cache, row, base = pool.cache, slot, 0
    if hasattr(cache, "shards"):
        k, row = pool._locate(slot)
        cache = cache.shards[k]
        base = k * getattr(pool, "nb_local", 0)
    kv = [cache["layers"][name] for name in ("k", "v")]
    if "block_tbl" in cache:
        ids = torch.as_tensor(pool.tables[slot, :-(-n // pool.block_size)]
                              - base, dtype=torch.long, device=kv[0].device)
        return torch.stack([x[:, ids].flatten(1, 2)[:, :n] for x in kv])
    return torch.stack([x[:, row, :n] for x in kv])


def kv_apart(torch, pool1, pool2, rows):
    """The slots among ``rows`` whose index or K/V differ bitwise between
    the two pools → {slot: the first layer whose K or V differs, or -1
    where the index does}."""
    idx = [pool.index.tolist() for pool in (pool1, pool2)]
    out = {}
    for r in rows:
        if idx[0][r] != idx[1][r]:
            out[r] = -1
            continue
        a, b = (slot_kv(torch, pool, r, idx[0][r]) for pool in (pool1, pool2))
        layers = (a != b).transpose(0, 1).flatten(1).any(1).nonzero()
        if len(layers):
            out[r] = int(layers[0])
    return out


def lockstep(torch, ops, one, two, requests, label):
    """Step the unsharded replica ``one`` and the sharded ``two`` side by
    side, each on its own ``requests()`` (all submitted at once, so request
    i takes slot i), both through the bulk path, and hold ``two`` to ``one``
    tick by tick on the rows whose input tokens still agree (FABRIC_*).
    → (each side's streams, the sharded side's launch counts, its host
    seconds a step, steps, what the ticks showed)."""
    logs = [recorded(rep.engine, rep.engine.decode) for rep in (one, two)]
    reqs = [requests(), requests()]
    for rep, rs in zip((one, two), reqs):
        for r in rs:
            rep.submit(r, now=0.0)
    n = len(reqs[0])
    done = [[], []]
    live, parted, seen = set(range(n)), {}, {"ticks": 0, "exact": 0,
                                             "exact_gap": 0.0,
                                             "later_gap": 0.0}
    counts = {name: 0 for name in ops.KERNELS}
    seconds, steps = 0.0, 0
    while len(done[0]) < n or len(done[1]) < n:
        steps += 1
        check(steps < 5000, f"{label}: the run did not finish")
        done[0].extend(one.step(float(steps)))
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        done[1].extend(two.step(float(steps)))
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        for name, c in ops.launch_counts().items():
            counts[name] += c - before[name]
        while seen["ticks"] < min(map(len, logs)) and live:
            t = seen["ticks"]
            seen["ticks"] += 1
            (tok1, l1), (tok2, l2) = logs[0][t], logs[1][t]
            live = {r for r in live if tok1[r] == tok2[r]}
            rows = sorted(live)
            gap = float((l1[rows] - l2[rows]).abs().max())
            limit = FABRIC_FIRST_GAP if t == 0 else FABRIC_TICK_GAP
            check(gap <= limit, f"{label}: decode tick {t}'s logits differ "
                  f"by {gap:.4g} on the rows still in step (> {limit})")
            if t == 0:
                seen["first_gap"] = gap
            flips = [r for r in rows
                     if int(l1[r].argmax()) != int(l2[r].argmax())]
            if not parted:
                apart = kv_apart(torch, one.engine.pool, two.engine.pool,
                                 rows)
                check(not apart or flips, f"{label}: K/V caches part at "
                      f"decode tick {t} (slot: first differing layer, -1 "
                      f"for the index: {apart}), before any row's greedy "
                      f"choice (logits within {gap:.4g})")
                if apart:
                    seen["cache_part"] = (t, min(apart.values()), gap)
                else:
                    seen["exact"] += 1
                    seen["exact_gap"] = max(seen["exact_gap"], gap)
            else:
                seen["later_gap"] = max(seen["later_gap"], gap)
            for r in flips:
                top = [l[r].topk(2).values for l in (l1, l2)]
                parted[r] = (t, min(float(v[0] - v[1]) for v in top), gap)
                live.discard(r)
            check(len(parted) <= FABRIC_MAX_PARTED,
                  f"{label}: rows {sorted(parted)} part from the unsharded "
                  f"replica's (at most {FABRIC_MAX_PARTED} may, at a "
                  f"near-tie): {parted}")
    streams = [{r.rid: list(r.tokens_out) for r in d} for d in done]
    return streams, counts, seconds / steps, steps, parted, seen


def sharded_phase(torch, ops, add):
    """(a) ShardedReplica on full-width qwen2.5-3b over a 2-shard mesh on
    cuda:0, 8 slots, dense then paged, on phase 3's requests, against the
    unsharded InProcessReplica on the same core: the unsharded replica's
    streams through its fused ticks and through the bulk path equal; the
    sharded replica, stepped beside the bulk one, is held to it tick by
    tick (``lockstep``); the write instances launch exactly 2 x 36 a
    decode tick; the weights are not copied.  → the unsharded streams."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import InProcessReplica, ShardedReplica
    from repro_torch.serving.engine import EngineCore
    opts = dict(zip(SERVE[::2], SERVE[1::2]))
    slots, max_seq = int(opts["--slots"]), int(opts["--max-seq"])
    cfg = get_config("qwen2.5-3b")
    core = EngineCore(cfg, max_seq, seed=0, device="cuda")
    weights = sum(p.numel() * p.element_size()
                  for p in core.params.parameters())
    mesh = make_mesh((FABRIC_SHARDS,), ("data",),
                     devices=["cuda:0"] * FABRIC_SHARDS)
    prompts = [np.asarray(r.prompt) for r in cli_requests(cfg)]
    out = {}
    for pool in ("dense", "paged"):
        base = InProcessReplica.build(cfg, slots=slots, max_seq=max_seq,
                                      core=core, pool=pool)
        want, base_s, base_steps = fabric_run(torch, base, cli_requests(cfg))
        del base
        free(torch)
        bulk = InProcessReplica.build(cfg, slots=slots, max_seq=max_seq,
                                      core=core, pool=pool)
        before = torch.cuda.memory_allocated()
        rep = ShardedReplica(cfg, slots=slots, max_seq=max_seq, core=core,
                             pool=pool, mesh=mesh)
        label = f"sharded {pool}"
        (same, got), counts, s, steps, parted, seen = lockstep(
            torch, ops, bulk, rep, lambda: cli_requests(cfg), label)
        grown = torch.cuda.memory_allocated() - before
        check(same == want, f"unsharded {pool}: the bulk path's streams "
              f"differ from the fused ticks' at "
              f"{first_difference(torch, core, prompts, same, want)}")
        eng = rep.engine
        check_launches(counts, sharded_launches(eng, FABRIC_SHARDS,
                                                pool == "paged"), label)
        add(counts)
        # request i took slot i
        differ = sorted(rid for rid in want if got[rid] != want[rid])
        check(set(differ) <= set(parted),
              f"{label}: streams {differ} differ from the unsharded "
              f"replica's where no row parted ({parted})")
        check(grown < weights / 2,
              f"{label}: the replica grew the card's memory by {grown} "
              f"bytes (the weights are {weights})")
        ticks = eng.logits_pulls
        part = seen.get("cache_part")
        print(f"  {label}: {len(want) - len(differ)} of {len(want)} greedy "
              f"streams equal the unsharded replica's (its fused and bulk "
              f"ticks agree); the K/V caches bitwise equal through "
              f"{seen['exact']} of {seen['ticks']} decode ticks, the "
              f"logits within {seen['exact_gap']:.3g} there (the first "
              f"tick's {seen['first_gap']:.3g}); "
              + (f"at tick {part[0]} the caches part first in layer "
                 f"{part[1]}'s K/V, the logits by {part[2]:.4g}; "
                 if part else "")
              + (", ".join(f"request {r} parts at tick {t} (margin {m:.4g}, "
                           f"tick gap {g:.4g})"
                           for r, (t, m, g) in sorted(parted.items()))
                 or "no row parts")
              + (f"; the rows still in step within {seen['later_gap']:.4g} "
                 f"after" if parted else "")
              + f"; {FABRIC_SHARDS} shards x {N_LAYERS} layers x {ticks} "
              f"decode ticks = {FABRIC_SHARDS * N_LAYERS * ticks} write "
              f"instances; logits_pulls {ticks}; host clock {s * 1e3:.2f} "
              f"ms a step over {steps} steps (unsharded, fused: "
              f"{base_s * 1e3:.2f} ms over {base_steps}); the replica's "
              f"pool and run added {grown / 2**30:.2f} GiB (weights "
              f"{weights / 2**30:.2f} GiB, not copied)")
        out[pool] = want
        del rep, eng, bulk
        free(torch)
    del core
    free(torch)
    return out["dense"]


def pod_phase(torch, want, out_dir: Path):
    """(b) A 2-rank DistributedPodReplica, both worker processes on cuda:0,
    each a full-width qwen2.5-3b in mirror mode, on phase 3's requests: the
    streams equal (a)'s unsharded replica's (a rank runs all 8 rows, as it
    does); a MetricsObserver on the head agrees with the stub at every
    poll; the head's info and digest rounds; each rank's launch counts and
    peak memory from its stats file."""
    from repro_torch.configs import get_config
    from repro_torch.serving import DistributedPodReplica, MetricsObserver
    opts = dict(zip(SERVE[::2], SERVE[1::2]))
    cfg = get_config("qwen2.5-3b")
    with worker_processes(out_dir) as spawned:
        try:
            t0 = time.perf_counter()
            pod = DistributedPodReplica(cfg, slots=int(opts["--slots"]),
                                        max_seq=int(opts["--max-seq"]),
                                        pod_size=POD_SIZE, device="cuda")
            start_s = time.perf_counter() - t0
            try:
                obs = MetricsObserver(pod.addr)
                info = obs.status()["pod"]
                check((info["rank"], info["size"], info["process_count"],
                       info["mode"]) == (0, POD_SIZE, POD_SIZE, "mirror"),
                      f"pod info {info}")
                polls = []
                got, s, steps = fabric_run(
                    torch, pod, cli_requests(cfg),
                    poll=lambda: polls.append(obs.lifetime()
                                              == pod.lifetime()))
                info = obs.status()["pod"]
                pulls = pod.lifetime()["logits_pulls"]
                obs.close()
            finally:
                pod.close()
            pids = [p.pid for p in spawned]
            for proc in spawned:
                proc.wait(timeout=60)
            counts, peaks = worker_stats(out_dir, pids)
        except Exception as e:
            codes = [(p.pid, p.poll()) for p in spawned]
            sys.stderr.flush()
            tail = (out_dir / "stderr.txt").read_text().splitlines()
            print(f"  pod FAILED: {e!r}; ranks (pid, exit code): {codes}; "
                  f"stderr tail:")
            for line in tail[-FLEET_STDERR_TAIL:]:
                print(f"    | {line}")
            if isinstance(e, SmokeFailure):
                raise
            raise SmokeFailure(f"pod: {e!r}") from e
    check(polls and all(polls), f"the observer disagreed with the stub at "
                                f"polls {[i for i, ok in enumerate(polls) if not ok]}")
    check(got == want, f"pod streams differ from the unsharded replica's: "
                       f"{sorted(r for r in want if got.get(r) != want[r])}")
    check(info["digest_rounds"] == steps,
          f"the head compared {info['digest_rounds']} digests in {steps} "
          f"steps")
    rank = {name: 0 for name in KERNEL_INFO}
    rank.update(decode_attention_write=N_LAYERS * pulls,
                flash_attention=N_LAYERS * len(want))
    check(counts == {k: POD_SIZE * v for k, v in rank.items()},
          f"the ranks' launch counts {counts}, expected {POD_SIZE} x {rank}")
    check(len(peaks) == POD_SIZE and all(peaks.values()),
          f"a rank never used the card: {peaks}")
    print(f"  pod of {POD_SIZE} ranks on cuda:0: up in {start_s:.1f} s; "
          f"{len(got)} streams equal (a)'s unsharded replica's; the "
          f"observer agreed with the "
          f"stub at all {len(polls)} polls; head info {info}; the head "
          f"compared {info['digest_rounds']} digest rounds; host clock "
          f"{s * 1e3:.2f} ms a step (observer polls included) over {steps} "
          f"steps; the ranks' launches, summed: "
          f"{ {k: v for k, v in counts.items() if v} }; each rank's peak "
          f"device memory: "
          f"{ {pid: round(b / 2**30, 2) for pid, b in peaks.items()} } GiB")


def sharded_loop_phase(torch, ops, cfg, lc, phase6, seed, add):
    """(c) Phase 6's loop (``LoopConfig()``) over the sharded topology, on
    the default mesh (one shard per card): TickLogs (every field but
    learn_loss) and streams equal phase 6's in-process run; the launch
    counts of the bulk path."""
    import dataclasses
    from repro_torch.serving.closed_loop import run_closed_loop
    sink, steps = [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_router_steps(torch, steps):
        router, logs = run_closed_loop(
            cfg, autoscale=True, ticks=LOOP_TICKS, seed=seed,
            lc=dataclasses.replace(lc, topology="sharded"), sink=sink,
            device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    try:
        got, want = trajectory(logs), trajectory(phase6["logs"])
        diff = next((i for i, (a, b) in enumerate(zip(got, want))
                     if a != b), None)
        check(len(got) == len(want) and diff is None,
              f"sharded loop: tick {diff} {got[diff] if diff is not None else ''}"
              f" vs phase 6's {want[diff] if diff is not None else ''}")
        streams = {r.rid: list(r.tokens_out) for r in sink}
        check(streams == phase6["streams"],
              "sharded loop: streams differ from phase 6's")
        reps = list(router.all_replicas)
        check({r.kind for r in reps} == {"sharded"},
              f"sharded loop built {[r.kind for r in reps]}")
        shards = reps[0].mesh.size
        want_counts = {name: 0 for name in KERNEL_INFO}
        for rep in reps:
            for name, n in sharded_launches(rep.engine, shards,
                                            False).items():
                want_counts[name] += n
        check_launches(counts, want_counts, "sharded loop")
        add(counts)
    finally:
        router.close()
    print(f"  phase 6's loop over topology sharded ({shards} shard a "
          f"replica, {len(reps)} replicas built): {len(logs)} TickLogs and "
          f"{len(streams)} streams equal phase 6's; router step "
          f"{statistics.mean(steps) * 1e3:.2f} ms mean host clock (phase "
          f"6: {phase6['step_ms'][0]:.2f}); "
          f"{time.perf_counter() - t0:.1f} s")


def fabric_phase(torch, ops, loop, seed, add):
    """Phase 11: (a) sharded replica, (b) pod, (c) the sharded loop."""
    import tempfile
    from repro_torch.kernels import _lib
    print(f"[11] the replica fabric on full-width qwen2.5-3b: a "
          f"{FABRIC_SHARDS}-shard mesh on one card, a {POD_SIZE}-rank pod, "
          f"the loop over the sharded topology ({gpu_line()})")
    streams = sharded_phase(torch, ops, add)
    pod_phase(torch, streams, Path(tempfile.mkdtemp(prefix="pod-",
                                                    dir=_lib.BUILD_DIR)))
    free(torch)
    sharded_loop_phase(torch, ops, loop["cfg"], loop["lc"], loop["planner"],
                       seed, add)
    free(torch)


# -------------------------------------------------------------------- phase 12
# the model axis: split-K decode over a sequence-split KV cache and
# expert-parallel MoE, every mesh's shards on cuda:0
AXIS_MESH = (1, 4)
AXIS_B, AXIS_PROMPT, AXIS_RING, AXIS_STEPS = 8, 200, 4096, 8
AXIS_F32_LAYERS, AXIS_F32_STEPS = 4, 4
# float32 logits within this x max(1, max |logit|) of the unsharded steps:
# the reference's own 1e-4, scaled to full-width logits
AXIS_F32_TOL = 1e-4
# bf16: split-K (the reference's casts: probabilities rounded to bf16
# before P·V) against K1's write instance (float32 probabilities) at every
# layer of a step.  Two vectors within AXIS_GAP can swap their argmax only
# where the top two lie closer than 2 x AXIS_GAP: a row's greedy choice may
# part there and nowhere else.  With random weights such near-ties are
# common (on the H100, 4 of 8 free-running rows part within 16 steps, at
# margins of 0.004-0.037), so the split-K steps are also run fed the
# unsharded run's tokens, and there every row's logits are held at every
# step.
AXIS_GAP = 0.25
SPLITK_SHARDS = 16
OLMOE_PROMPT, OLMOE_STEPS = 64, 4
# (d): each layout's (ring slots, paged) on LAYOUT_MESH, 8 rows prefilled
# with LAYOUT_PROMPT tokens then set to LAYOUT_INDICES (row 2's 256-slot
# ring wrapped), LAYOUT_STEPS steps; paged: LAYOUT_BLOCK-slot blocks
LAYOUT_MESH = (2, 2)
LAYOUTS = {"split ring, per-row index": (256, False),
           "ring of 4095 (KV heads split)": (4095, False),
           "paged pool": (256, True)}
LAYOUT_PROMPT, LAYOUT_STEPS, LAYOUT_BLOCK = 128, 2, 16
LAYOUT_INDICES = (128, 100, 300, 64, 200, 17, 255, 90)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


@contextlib.contextmanager
def launches_into(ops, out):
    """The kernels' launches in the block, added into ``out``."""
    before = ops.launch_counts()
    try:
        yield
    finally:
        for k, n in ops.launch_counts().items():
            if n != before[k]:
                out[k] = out.get(k, 0) + n - before[k]


def greedy(torch, ops, logits):
    """K3 at temperature 0 on the last position's float32 logits → (B, 1)
    int32."""
    rows = logits[:, -1].float()
    z = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    return ops.fused_sample(rows, z, z, z, z.float())[:, None]


def axis_run(torch, ops, model, logits, cache, steps, ctx, feed=None):
    """``steps`` greedy decode steps from the prefill's ``logits`` under
    ``ctx()``: (tokens [(B, 1)], each picked by K3 from the logits beside
    it, logits [(B, V) float32] the prefill's first, the last cache).
    ``feed``: ``steps + 1`` tokens to take instead of the run's own picks
    (teacher forcing)."""
    from repro_torch.models.steps import make_decode_step
    step = make_decode_step(model.cfg)
    toks, outs = [], [logits[:, -1].float()]
    for t in range(steps + 1):
        toks.append(greedy(torch, ops, logits) if feed is None else feed[t])
        if t == steps:
            break
        with ctx():
            logits, cache = step(model, toks[-1], cache)
        outs.append(logits[:, 0].float())
    return toks, outs, cache


def near_tie(torch, logits, row, what):
    """The top-two margin of ``logits[row]``; fails unless it is under
    2 x AXIS_GAP (a greedy choice may part only at such a near-tie)."""
    top = logits[row].topk(2).values
    margin = float(top[0] - top[1])
    check(margin < 2 * AXIS_GAP, f"{what}: the greedy choice parts at a "
          f"margin of {margin:.4g} (>= {2 * AXIS_GAP})")
    return margin


def held_forced(torch, one, two, label):
    """Run ``two`` was fed run ``one``'s tokens: every row's logits within
    AXIS_GAP at every step, and their greedy choices equal but at
    near-ties.  → (worst gap, [(step, row, margin)] where they differ)."""
    worst, flips = 0.0, []
    for t, (a, b) in enumerate(zip(one, two)):
        gap = float((a - b).abs().max())
        check(gap <= AXIS_GAP, f"{label}: step {t}'s logits differ by "
              f"{gap:.4g} (> {AXIS_GAP})")
        worst = max(worst, gap)
        for r in (a.argmax(-1) != b.argmax(-1)).nonzero()[:, 0].tolist():
            flips.append((t, r, near_tie(torch, a, r,
                                         f"{label}: step {t} row {r}")))
    return worst, flips


def held_in_step(torch, one, two, label):
    """Free-running runs ``one`` and ``two`` (each (tokens, logits)), held
    step by step on the rows whose tokens agree so far: logits within
    AXIS_GAP; a row parts only at a near-tie of ``one``'s logits.  →
    (worst gap, {row: (step, margin)})."""
    (toks1, l1), (toks2, l2) = one, two
    live, parted, worst = set(range(l1[0].shape[0])), {}, 0.0
    for t in range(len(l1)):
        rows = sorted(live)
        gap = float((l1[t][rows] - l2[t][rows]).abs().max()) if rows else 0.0
        check(gap <= AXIS_GAP, f"{label}: step {t}'s logits differ by "
              f"{gap:.4g} on the rows still in step (> {AXIS_GAP})")
        worst = max(worst, gap)
        a, b = toks1[t][:, 0].tolist(), toks2[t][:, 0].tolist()
        for r in rows:
            if a[r] != b[r]:
                parted[r] = (t, near_tie(torch, l1[t], r,
                                         f"{label}: step {t} row {r}"))
                live.discard(r)
    return worst, parted


def streams_line(parted, n) -> str:
    return (f"{n - len(parted)} of {n} streams equal" + (
        "; parted (row: step, margin) " + ", ".join(
            f"{r}: {t}, {m:.3g}" for r, (t, m) in sorted(parted.items()))
        if parted else ""))


def splitk_alone(torch, ops, mesh, seed=31):
    """The split-K body alone at qwen2.5-3b's decode shapes (8 rows, 16
    heads over 2, hd 128, a 4096-slot ring split over 4 shards), the new
    row in the first and in the last shard: float32 within 1e-4 of
    ``sdpa_ref`` over the written cache; bf16 within ATTN_TOL of K1's
    write instance, the written caches bitwise equal."""
    from repro_torch.models.attention import NEG_INF, Attention, sdpa_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    B, H, KV, hd, Smax = AXIS_B, 16, 2, 128, AXIS_RING
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, k, v = rnd(B, 1, H, hd), rnd(B, 1, KV, hd), rnd(B, 1, KV, hd)
        kc, vc = rnd(B, Smax, KV, hd), rnd(B, Smax, KV, hd)
        for index in (AXIS_PROMPT, Smax - 1):
            idx = torch.tensor(index, dtype=torch.int32, device=dev)
            sk_cache = {"k": kc.clone(), "v": vc.clone()}
            out, got = Attention._decode_splitk(q, k, v, sk_cache, idx, mesh,
                                                ("data",), mesh.shape["model"])
            k2, v2 = kc.clone(), vc.clone()
            if dt == torch.float32:
                k2[:, index], v2[:, index] = k[:, 0], v[:, 0]
                slots = torch.arange(Smax, device=dev)
                bias = torch.where(slots <= index, 0.0, NEG_INF).expand(
                    B, 1, Smax).float()
                want, tol = sdpa_ref(q, k2, v2, bias), 1e-4
            else:
                want = ops.decode_attention_write(
                    q, k[:, 0], v[:, 0], k2, v2, idx.expand(B))
                tol = ATTN_TOL
            err = max_err(torch, out, want, tol,
                          f"split-K alone {dt} index {index}")
            worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
            check(torch.equal(got["k"].full(), k2)
                  and torch.equal(got["v"].full(), v2),
                  f"split-K alone {dt} index {index}: the written cache "
                  f"differs from the plain write")
    print(f"  split-K alone, (8,1,16,128) over a 4096-slot ring on "
          f"{mesh.shape['model']} shards, the row in the first and the last "
          f"shard: float32 vs sdpa_ref max|err| {worst['torch.float32']:.3g} "
          f"(<= 1e-4), bf16 vs K1's write instance "
          f"{worst['torch.bfloat16']:.3g} (<= {ATTN_TOL}); caches bitwise "
          f"equal")


def qwen_axis_runs(torch, ops, model, mesh, counts):
    """(a) full-width qwen2.5-3b: one prefill, then AXIS_STEPS greedy steps
    on one device (K1's write instance) and through the partition under
    ``shard_ctx(SERVE_RULES, mesh)`` from a copy of the same cache (the
    ring's sequence over "model": the split-K body).  → the prompts."""
    import numpy as np
    from repro_torch.models.attention import Attention
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.sharding import SERVE_RULES, ShardedArray, shard_ctx
    cfg = model.cfg
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (AXIS_B, AXIS_PROMPT), dtype=np.int32)).cuda()
    with launches_into(ops, counts):
        logits, cache = make_prefill_step(cfg, AXIS_RING)(
            model, {"tokens": prompts})
    before = clone_tree(cache)
    ctx = lambda: shard_ctx(SERVE_RULES, mesh)
    seen = []
    real = Attention.__dict__["_splitk_body"]

    def spy(qs, ks, vs, *a):
        first = next(iter(ks))
        seen.append((ks[first].clone(), vs[first].clone()))
        return real.__func__(qs, ks, vs, *a)

    un_counts, sk_counts = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launches_into(ops, un_counts):
        un = axis_run(torch, ops, model, logits, cache, AXIS_STEPS,
                      contextlib.nullcontext)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # step 1 alone first, to read the rows it wrote
    sk_cache = clone_tree(before)
    Attention._splitk_body = staticmethod(spy)
    try:
        with launches_into(ops, sk_counts):
            first = axis_run(torch, ops, model, logits, sk_cache, 1, ctx)
    finally:
        Attention._splitk_body = real
    check(len(seen) == cfg.n_layers, f"the split-K body ran in {len(seen)} "
          f"of {cfg.n_layers} layers")
    split = first[2]["layers"]
    check(all(isinstance(split[n], ShardedArray) for n in ("k", "v")),
          "the split-K cache came back whole")
    slot = AXIS_PROMPT
    whole = {n: split[n].full() for n in ("k", "v")}
    un1 = cache["layers"]     # the unsharded run wrote step 1's row there
    for n, i in (("k", 0), ("v", 1)):
        rows = torch.stack([s[i] for s in seen])
        check(torch.equal(whole[n][:, :, slot], rows),
              f"step 1: a written {n} row is not the body's new row")
        old = before["layers"][n]
        check(torch.equal(whole[n][:, :, :slot], old[:, :, :slot])
              and torch.equal(whole[n][:, :, slot + 1:], old[:, :, slot + 1:]),
              f"step 1: split-K changed a {n} slot other than {slot}")
        check(torch.equal(whole[n][0, :, slot], un1[n][0, :, slot]),
              f"step 1: layer 0's {n} row differs from the unsharded write")
    same = sum(torch.equal(whole["k"][i, :, slot], un1["k"][i, :, slot])
               for i in range(cfg.n_layers))
    del whole, un1, first
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with launches_into(ops, sk_counts):
        sk = axis_run(torch, ops, model, logits, clone_tree(before),
                      AXIS_STEPS, ctx)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with launches_into(ops, sk_counts):
        forced = axis_run(torch, ops, model, logits, clone_tree(before),
                          AXIS_STEPS, ctx, feed=un[0])
    check(sk_counts.get("decode_attention_write", 0) == 0
          and sk_counts.get("decode_attention", 0) == 0,
          f"split-K steps launched decode kernels: {sk_counts}")
    check(un_counts.get("decode_attention_write") == AXIS_STEPS
          * cfg.n_layers, f"unsharded steps launched {un_counts}")
    worst, parted = held_in_step(torch, un[:2], sk[:2],
                                 "qwen2.5-3b split-K vs K1")
    f_worst, flips = held_forced(torch, un[1], forced[1],
                                 "qwen2.5-3b split-K fed K1's tokens")
    for c in (un_counts, sk_counts):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
    print(f"  (a) qwen2.5-3b, 36 layers bf16, {AXIS_B} x {AXIS_PROMPT}-token"
          f" prompts in a {AXIS_RING}-slot ring, {AXIS_STEPS} greedy steps "
          f"through the partition on a {AXIS_MESH} mesh (laid out "
          f"{split['k'].spec}): step 1's written K/V rows are the body's "
          f"new rows bitwise in all {cfg.n_layers} layers (layer 0's equal "
          f"the unsharded write; {same} of {cfg.n_layers} layers' K rows "
          f"equal it), no other slot changed; fed K1's tokens, every row's "
          f"logits within {f_worst:.4g} of K1's (<= {AXIS_GAP}), greedy "
          f"choices apart at {len(flips)} (step, row) near-ties {flips}; "
          f"free-running, logits on rows in step within {worst:.4g}, "
          f"{streams_line(parted, AXIS_B)}; "
          f"host clock a step: unsharded {(t1 - t0) / AXIS_STEPS * 1e3:.2f} "
          f"ms, split-K {(t3 - t2) / AXIS_STEPS * 1e3:.2f} ms; launches "
          f"unsharded {un_counts}, split-K {sk_counts}", flush=True)
    return prompts


def f32_axis_runs(torch, ops, prompts, mesh, counts):
    """(a) in float32 at AXIS_F32_LAYERS layers, TF32 off: the partition's
    logits within AXIS_F32_TOL x max(1, max |logit|) of the one-device
    steps, both fed the one-device run's tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.sharding import SERVE_RULES, shard_ctx
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              n_layers=AXIS_F32_LAYERS, dtype="float32",
                              param_dtype="float32")
    model = LM(cfg, device="cuda", seed=0)
    with launches_into(ops, counts):
        logits, cache = make_prefill_step(cfg, AXIS_RING)(
            model, {"tokens": prompts})
        before = clone_tree(cache)
        un = axis_run(torch, ops, model, logits, cache, AXIS_F32_STEPS,
                      contextlib.nullcontext)
        sk = axis_run(torch, ops, model, logits, before, AXIS_F32_STEPS,
                      lambda: shard_ctx(SERVE_RULES, mesh), feed=un[0])
    worst = 0.0
    for t, (a, b) in enumerate(zip(un[1], sk[1])):
        err = float((a - b).abs().max())
        limit = AXIS_F32_TOL * max(1.0, float(a.abs().max()))
        check(err <= limit, f"float32 split-K step {t}: logits differ by "
              f"{err:.4g} (> {limit:.4g})")
        worst = max(worst, err / limit)
    print(f"  (a) qwen2.5-3b float32 at {AXIS_F32_LAYERS} layers, "
          f"{AXIS_F32_STEPS} steps: split-K logits within {worst:.3g} of "
          f"the allowance {AXIS_F32_TOL} x max(1, max|logit|)", flush=True)
    del model, cache, before
    free(torch)


def partition_decode_records(cfg, B, m):
    """The collectives (kind, result bytes, group size) of one decode step
    of a dense model like qwen2.5-3b (tied embeddings, QKV bias, bf16
    weights, 2 KV heads, a vocabulary and q heads that "model" divides)
    through the partition on a (1, m) mesh under SERVE_RULES, the ring's
    sequence over "model": the embedding's psum over the vocabulary; a
    layer: wk, wv and their biases gathered whole (their columns split
    over "model", their KV heads do not), q gathered over "model",
    split-K's pmax of m and psum of l (B, KV, G) and psum of o (B, KV, G,
    hd) in float32, the psums of wo's and the MLP's rows; the float32
    logits gathered over the vocabulary, then over "data" (of 1: no
    bytes)."""
    it, f = 2, 4
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    kv_w = ([("all-gather", d * KV * hd * it, m)] * 2
            + [("all-gather", KV * hd * it, m)] * 2 * cfg.qkv_bias)
    layer = (kv_w + [("all-gather", B * H * hd * it, m)]
             + [("all-reduce", B * KV * G * f, m)] * 2
             + [("all-reduce", B * KV * G * hd * f, m)]
             + [("all-reduce", B * d * it, m)] * 2)
    return ([("all-reduce", B * d * it, m)] + layer * L
            + [("all-gather", B * V * f, m), ("all-gather", B * V * f, 1)])


def decode_32k_splitk(torch, ops, model, counts):
    """(b) one card's share of qwen2.5-3b decode_32k (8 rows over a
    32768-slot ring, index 32767) through the partition over a (1,
    SPLITK_SHARDS) mesh on cuda:0, beside the one-device step: CUDA-event
    times, peaks, the collectives and their wire bytes, the logits."""
    from collections import Counter
    from repro_torch.launch.cost import CostCounter, collective_bytes
    from repro_torch.launch.dryrun import _timed, build_cell, collective_sizes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import SHAPES
    from repro_torch.sharding import SERVE_RULES, shard_ctx
    dev = torch.device("cuda")
    shape = SHAPES["decode_32k"]
    _, step, args = build_cell(model.cfg, shape, dev, params=model)
    args[2]["index"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                    device=dev)
    mesh = make_mesh((1, SPLITK_SHARDS), ("data", "model"),
                     devices=["cuda:0"] * SPLITK_SHARDS)
    ctx = lambda: shard_ctx(SERVE_RULES, mesh)
    out = {}
    for label, c in (("one device", contextlib.nullcontext),
                     ("partition", ctx)):
        with launches_into(ops, counts), c():
            step(*args)                                   # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logits = step(*args)[0][:, 0].float()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            runs = _timed(step, args, dev, 2)
        out[label] = (logits, peak, statistics.median(runs), runs)
    with ctx(), CostCounter() as counter:
        step(*args)
    wire, detail = collective_bytes(counter)
    want = partition_decode_records(model.cfg, args[1].shape[0],
                                    SPLITK_SHARDS)
    check(Counter(counter.collectives) == Counter(want),
          f"decode_32k partition: collectives {Counter(counter.collectives)}"
          f", expected {Counter(want)}")
    want_wire = collective_bytes(want)[0]
    check(wire == want_wire, f"decode_32k partition: {wire} wire bytes a "
          f"device, expected {want_wire:.0f}")
    (l_un, p_un, s_un, r_un), (l_sk, p_sk, s_sk, r_sk) = \
        out["one device"], out["partition"]
    check(p_sk <= p_un + 2**30, f"decode_32k partition peak "
          f"{p_sk / 2**30:.2f} GiB > one device's {p_un / 2**30:.2f} + 1 "
          f"GiB: the cache was gathered")
    gap = float((l_sk - l_un).abs().max())
    check(gap <= AXIS_GAP, f"decode_32k partition logits {gap:.4g} from the "
          f"one-device step's")
    ms = lambda rs: ", ".join(f"{x * 1e3:.2f}" for x in rs)
    top = "; ".join(f"{k} {b} B over {n} x {c}: {w:.0f}" for k, b, n, c, w
                    in collective_sizes(counter)[:3])
    print(f"  (b) decode_32k (8 x ring 32768, index 32767) through the "
          f"partition over {SPLITK_SHARDS} positions on one card: step_s "
          f"{s_sk * 1e3:.2f} ms (runs {ms(r_sk)}), one device "
          f"{s_un * 1e3:.2f} ms (runs {ms(r_un)}); peak {p_sk / 2**30:.2f} "
          f"GiB vs {p_un / 2**30:.2f} GiB; collectives {detail['counts']} "
          f"as derived from the shapes, {wire:.0f} wire bytes a device "
          f"(largest: {top}); logits within {gap:.4g}", flush=True)
    del args, out
    free(torch)


def olmoe_axis_runs(torch, ops, counts):
    """(c) olmoe-1b-7b at full width (64 experts, top 8) through the
    partition: a (1, 4) mesh at the config's capacity factor (every MoE
    layer's expert-parallel result held against the global path on the
    same tokens and weights), then a dropless copy on (2, 2) whose
    streams are held to the one-device run's."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import serve_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.moe import MoE
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.sharding import SERVE_RULES, no_shard_ctx, shard_ctx
    from repro_torch.sharding import shard_map as sm
    cfg = serve_config(get_config("olmoe-1b-7b"))
    model = LM(cfg, device="cuda", seed=0)
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    real = MoE.forward_mesh
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (AXIS_B, OLMOE_PROMPT), dtype=np.int32)).cuda()
    seen = {"calls": 0, "y": 0.0, "dropped": 0.0}

    def hold(mod, w, xs, batch_axes):
        out = real(mod, w, xs, batch_axes)
        row = sm.canonical((batch_axes,))
        x = sm.join(xs, row, w.mesh)
        if mod._ep_ctx(x.shape[0]) is None:
            return out
        first = sm.positions(w.mesh)[0]
        with no_shard_ctx():
            y_g, aux_g = mod._apply_global(
                x, train=True, router_w=w("router.w", ())[first],
                experts=tuple(w(n, ())[first].to(mod.dtype)
                              for n in ("gate", "up", "down")))
        y, aux = sm.join(out[0], row, w.mesh), out[1]
        for k in ("drop_frac", "expert_load"):
            check(torch.equal(aux[k], aux_g[k]), f"olmoe EP call "
                  f"{seen['calls']}: {k} differs from the global path's")
        seen["y"] = max(seen["y"], max_err(torch, y, y_g, ATTN_TOL,
                                           "olmoe EP vs global y"))
        seen["dropped"] = max(seen["dropped"], float(aux["drop_frac"]))
        seen["calls"] += 1
        return out

    def run(ctx, feed=None):
        with launches_into(ops, counts), ctx():
            logits, cache = make_prefill_step(
                model.cfg, OLMOE_PROMPT + OLMOE_STEPS)(
                model, {"tokens": prompts})
        with launches_into(ops, counts):
            return axis_run(torch, ops, model, logits, cache, OLMOE_STEPS,
                            ctx, feed=feed)[:2]

    glob = run(contextlib.nullcontext)
    MoE.forward_mesh = hold
    try:
        mesh = make_mesh(AXIS_MESH, ("data", "model"),
                         devices=["cuda:0"] * math.prod(AXIS_MESH))
        ep = run(lambda: shard_ctx(SERVE_RULES, mesh))
    finally:
        MoE.forward_mesh = real
    check(seen["calls"] == len(moes) * (1 + OLMOE_STEPS),
          f"olmoe: {seen['calls']} EP calls held")
    same = sum(torch.equal(a, b) for a, b in zip(glob[0], ep[0]))
    # the dropless copy: its config too, which the partition's modules are
    # built from (``steps.meta_model``)
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    for m in moes:
        m.mcfg = model.cfg.moe
    glob_free = run(contextlib.nullcontext)
    mesh22 = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    ep_free = run(lambda: shard_ctx(SERVE_RULES, mesh22))
    worst, parted = held_in_step(torch, glob_free, ep_free,
                                 "olmoe dropless EP + split-K on (2, 2)")
    forced = run(lambda: shard_ctx(SERVE_RULES, mesh22), feed=glob_free[0])
    f_worst, flips = held_forced(torch, glob_free[1], forced[1],
                                 "olmoe dropless EP fed the global tokens")
    print(f"  (c) olmoe-1b-7b at {cfg.n_layers} layers, {AXIS_B} x "
          f"{OLMOE_PROMPT}-token prompts, {OLMOE_STEPS} steps: on {AXIS_MESH} "
          f"at capacity factor {cfg.moe.capacity_factor} {seen['calls']} EP "
          f"calls held (drop_frac and expert_load equal the global path's, "
          f"drop_frac up to {seen['dropped']:.4g}; y within "
          f"{seen['y']:.4g} <= {ATTN_TOL}); {same} of {len(glob[0])} token "
          f"steps equal the global run's (printed only); dropless on (2, 2) "
          f"fed the global run's tokens: every row's logits within "
          f"{f_worst:.4g} (<= {AXIS_GAP}), choices apart at near-ties "
          f"{flips}; free-running: logits on rows in step within "
          f"{worst:.4g}, {streams_line(parted, AXIS_B)}", flush=True)
    del model, moes
    free(torch)


def to_layout(torch, cache, ring, paged, seed=13):
    """A one-device prefill's cache in (d)'s layout: every row at its own
    position (LAYOUT_INDICES); ``paged``: the K/V re-laid as a pool of B x
    nk + 1 blocks of LAYOUT_BLOCK slots in a shuffled order, the (B, nk)
    table naming them, every other row's ids offset by NB (global ids,
    which ``rem(block_tbl, NB)`` folds)."""
    import numpy as np
    layers = cache["layers"]
    L, B = layers["k"].shape[:2]
    dev = layers["k"].device
    out = {**cache, "index": torch.tensor(LAYOUT_INDICES[:B],
                                          dtype=torch.int32, device=dev)}
    if not paged:
        return out
    nk = ring // LAYOUT_BLOCK
    NB = B * nk + 1
    ids = torch.from_numpy(np.random.default_rng(seed).permutation(NB)[
        :B * nk]).to(dev)
    pool = {}
    for n, leaf in layers.items():
        p = torch.zeros((L, NB, LAYOUT_BLOCK) + leaf.shape[3:],
                        dtype=leaf.dtype, device=dev)
        p[:, ids] = leaf.reshape((L, B * nk, LAYOUT_BLOCK) + leaf.shape[3:])
        pool[n] = p
    tbl = ids.reshape(B, nk).to(torch.int32)
    tbl[::2] += NB
    return {**out, "layers": pool, "block_tbl": tbl}


def written_rows(torch, cache, ring, paged, steps):
    """{"k", "v"}: (L, B x steps, KV, hd) — the rows the decode steps wrote
    (row b at index[b] + t for t < steps), read from a cache whole or laid
    out."""
    from repro_torch.sharding import shard_map as sm
    layers = {n: (t.full() if isinstance(t, sm.ShardedArray) else t)
              for n, t in cache["layers"].items()}
    dev = layers["k"].device
    idx = torch.tensor(LAYOUT_INDICES, dtype=torch.long, device=dev)
    B = idx.shape[0]
    pos = (idx[:, None] + torch.arange(steps, device=dev)).reshape(-1) % ring
    rows = torch.arange(B, device=dev).repeat_interleave(steps)
    if paged:
        tbl = cache["block_tbl"].long() % layers["k"].shape[1]
        blk = tbl[rows, pos // LAYOUT_BLOCK]
        return {n: t[:, blk, pos % LAYOUT_BLOCK] for n, t in layers.items()}
    return {n: t[:, rows, pos] for n, t in layers.items()}


def cuda_ms(torch, fn):
    """(fn's result, its host clock and its CUDA-event time in ms)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def layout_runs(torch, ops, model, counts):
    """(d) full-width qwen2.5-3b on LAYOUT_MESH under ``serve_rules(8)``,
    8 rows at their own positions, LAYOUT_STEPS steps in each of LAYOUTS
    beside one device and a float32 witness of the same weights, fed one
    device's tokens (``to_layout`` from each model's own prefill)."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.cost import CostCounter, collective_bytes
    from repro_torch.launch.dryrun import collective_sizes
    from repro_torch.models import LM
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import serve_rules, shard_ctx
    from repro_torch.sharding import shard_map as sm
    cfg = model.cfg
    mesh = card_mesh(LAYOUT_MESH)
    B = len(LAYOUT_INDICES)
    rules = serve_rules(B)
    positions = mesh.size
    model32 = LM(dataclasses.replace(cfg, dtype="float32",
                                     param_dtype="float32"), device="cuda",
                 seed=0)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p.float())
    model32.recast()
    rng = np.random.default_rng(21)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, LAYOUT_PROMPT), dtype=np.int32)).cuda()}
    dec = make_decode_step(cfg)
    write = {False: "decode_attention_write",
             True: "decode_attention_paged_write"}
    for label, (ring, paged) in LAYOUTS.items():
        pre = make_prefill_step(cfg, ring)
        with launches_into(ops, counts):
            l1, c1 = pre(model, batch)
            _, c32 = pre(model32, batch)
        c1, c32 = (to_layout(torch, c, ring, paged) for c in (c1, c32))
        c2 = clone_tree(c1)
        with launches_into(ops, counts):
            tok = greedy(torch, ops, l1)
        gaps = {"logits": (0.0, 0.0)}
        one_ms, mesh_ms, one_ev, mesh_ev = [], [], [], []
        mesh_counts: dict = {}
        for _ in range(LAYOUT_STEPS):
            with launches_into(ops, counts):
                (d1, c1), h1, e1 = cuda_ms(torch, lambda: dec(model, tok, c1))
            with shard_ctx(rules, mesh), launches_into(ops, mesh_counts):
                (d2, c2), h2, e2 = cuda_ms(torch, lambda: dec(model, tok, c2))
            with launches_into(ops, counts):
                d32, c32 = dec(model32, tok, c32)
            g = witness_gaps(d1[:, 0], d2[:, 0], d32[:, 0])["logits"]
            gaps["logits"] = tuple(map(max, zip(g, gaps["logits"])))
            one_ms.append(h1)
            mesh_ms.append(h2)
            one_ev.append(e1)
            mesh_ev.append(e2)
            with launches_into(ops, counts):
                tok = greedy(torch, ops, d1)
        for k, n in mesh_counts.items():
            counts[k] = counts.get(k, 0) + n
        split_k = not paged and ring % LAYOUT_MESH[1] == 0
        want = {} if split_k else {
            write[paged]: positions * cfg.n_layers * LAYOUT_STEPS}
        check(mesh_counts == want, f"(d) {label}: the mesh's decode launched "
              f"{mesh_counts}, expected {want} (a write instance a layer on "
              f"each position, split-K none)")
        rows = [written_rows(torch, c, ring, paged, LAYOUT_STEPS)
                for c in (c1, c2, c32)]
        for n in ("k", "v"):
            gaps[f"written {n}"] = witness_gaps(
                rows[0][n], rows[1][n], rows[2][n])["logits"]
        check(witness_held(gaps), f"(d) {label}, one device / the mesh "
              f"against the float32 witness: {witness_line(gaps)} (the mesh "
              f"within {WITNESS_RATIO} x one device)")
        check(torch.equal(c2["index"], c1["index"]) and (
            not paged or torch.equal(c2["block_tbl"], c1["block_tbl"])),
            f"(d) {label}: the index or the block table differs")
        with shard_ctx(rules, mesh), CostCounter() as counter, \
                launches_into(ops, counts):
            dec(model, tok, sm.clone_tree(c2))
        wire, detail = collective_bytes(counter)
        top = "; ".join(f"{k} {b} B over {n} x {c}: {w:.0f}"
                        for k, b, n, c, w in collective_sizes(counter)[:3])
        spec = c2["layers"]["k"].spec
        med = lambda xs: statistics.median(xs)
        print(f"  (d) {label}: {B} rows at {LAYOUT_INDICES} over "
              f"{LAYOUT_MESH} on cuda:0 (K/V laid out {spec}"
              f"{', blocks of ' + str(LAYOUT_BLOCK) if paged else ''}), "
              f"{LAYOUT_STEPS} steps fed one device's tokens: one device / "
              f"the mesh against the float32 witness {witness_line(gaps)} "
              f"(the mesh within {WITNESS_RATIO} x one device); mesh "
              f"launches {mesh_counts or 'none (split-K)'}; a step: host "
              f"clock {med(mesh_ms):.1f} ms, CUDA events {med(mesh_ev):.1f} "
              f"ms (one device {med(one_ms):.1f}, {med(one_ev):.1f}); "
              f"collectives {detail['counts']}, {wire:.0f} wire bytes a "
              f"device (largest: {top})", flush=True)
        del c1, c2, c32
    del model32
    free(torch)


def model_axis_phase(torch, ops, add):
    """Phase 12: split-K alone, (a) qwen2.5-3b bf16 and float32, (b)
    decode_32k over 16 positions, (c) olmoe-1b-7b EP, (d) every cache
    layout of serve_rules, all through the serve partition."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import serve_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    print(f"[12] the model axis through the serve partition: split-K decode, "
          f"expert-parallel MoE and every cache layout on meshes laid on "
          f"one card ({gpu_line()})")
    t0 = time.perf_counter()
    mesh = make_mesh(AXIS_MESH, ("data", "model"),
                     devices=["cuda:0"] * math.prod(AXIS_MESH))
    splitk_alone(torch, ops, mesh)
    counts = {}
    ops.reset_launch_counts()
    model = LM(serve_config(get_config("qwen2.5-3b")), device="cuda", seed=0)
    clock = {}
    t1 = time.perf_counter()
    prompts = qwen_axis_runs(torch, ops, model, mesh, counts)
    free(torch)
    clock["a"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    decode_32k_splitk(torch, ops, model, counts)
    clock["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    layout_runs(torch, ops, model, counts)
    clock["d"] = time.perf_counter() - t1
    del model
    free(torch)
    t1 = time.perf_counter()
    f32_axis_runs(torch, ops, prompts, mesh, counts)
    clock["a"] += time.perf_counter() - t1
    t1 = time.perf_counter()
    olmoe_axis_runs(torch, ops, counts)
    clock["c"] = time.perf_counter() - t1
    check(counts == {k: n for k, n in ops.launch_counts().items() if n},
          f"phase 12 launches {counts} != the counters' "
          f"{ops.launch_counts()}")
    for name in ("flash_attention", "decode_attention_write",
                 "decode_attention_paged_write", "fused_sample"):
        check(counts.get(name, 0) > 0, f"phase 12 never launched {name}")
    add(counts)
    print(f"  phase 12 launches {counts}; "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in sorted(clock.items()))
          + f"; {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- phase 13
# training over a ("data", "model") mesh whose positions all lie on cuda:0:
# a collective is a copy within the card.  (a) qwen2.5-3b full width and
# depth on (2, 2) through the launcher, beside the one-device launcher run
# on the same batches; a float32 copy at 4 layers held leaf by leaf;
# (b) padded heads: qwen2.5-14b at 2 of 48 layers on (1, 16); (c) elastic:
# 4 layers, (2, 2) → checkpoint → (1, 4); (d) olmoe-1b-7b at DEPTH_CUT
# layers on (2, 2), dropless and at cf 1.25
MESH_TRAIN = (2, 2)
MESH_TRAIN_STEPS = 2
MESH_TOL = 1e-2               # bf16 compute, the mesh's partial sums round
MESH_F32_TOL = 1e-5           # float32 compute, leaves by their max (>= 1)
LR, ADAM_B1 = 3e-4, 0.9       # the launcher's default lr, AdamW's b1
ADAM_NOISE_G = 1e-6           # 100 x AdamW's eps: below, |g| is rounding
MESH_SHORT_LAYERS = 4         # the float32 copy's and the elastic run's
PAD_MESH = (1, 16)
PAD_LAYERS = 2                # of qwen2.5-14b's 48: 2.1 B parameters
ELASTIC_MESH = (1, 4)


def card_mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"),
                     devices=["cuda:0"] * math.prod(shape))


def mesh_runs(torch, cfg, shape, batches, keep=(), stats=None,
              count=False):
    """One seeded state stepped over ``batches`` on the card alone, then the
    same init laid out on ``shape`` (positions on cuda:0) and stepped over
    them → (one-device metrics, mesh metrics, mesh host clock a step after
    the first, mesh peak GiB, (one-device state, mesh state), each None
    unless ``keep`` names it: "one", "mesh").  ``stats``, a dict, gets
    {"one": (host clock a step after the first, peak GiB), "mesh": ...},
    and with ``count`` "counter": the ``CostCounter`` the mesh steps ran
    under."""
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.elastic import state_shardings
    from repro_torch.models import steps
    from repro_torch.sharding import TRAIN_RULES, device_put, shard_ctx
    step, (opt_init, _) = steps.make_train_step(cfg)
    mesh = card_mesh(shape)
    out, clocks, states = [], [], []
    for label, on_mesh in (("one", False), ("mesh", True)):
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        state = steps.init_train_state(0, cfg, opt_init, device="cuda")
        if on_mesh:
            state = device_put(state, state_shardings(cfg, mesh)[0])
        ms = []
        counter = CostCounter() if count and on_mesh else None
        for b in batches:
            t0 = time.perf_counter()
            with shard_ctx(TRAIN_RULES, mesh) if on_mesh else \
                    contextlib.nullcontext(), \
                    counter or contextlib.nullcontext():
                state, m = step(state, b)
            ms.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            clocks.append(time.perf_counter() - t0)
        out.append(ms)
        states.append(state if label in keep else None)
        del state
        if stats is not None:
            run = clocks[-len(batches):]
            stats[label] = (statistics.mean(run[1:] or run), peak_gib(torch))
            if counter is not None:
                stats["counter"] = counter
    per_step = statistics.mean(clocks[len(batches) + 1:] or clocks[-1:])
    return out[0], out[1], per_step, peak_gib(torch), states


def held_metrics(one, mesh, keys, tol, what) -> float:
    """The largest relative gap of ``keys`` over the steps; fails past
    ``tol``."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(one, mesh, strict=True)):
        for k in keys:
            gap = rel_gap(b[k], a[k])
            check(gap <= tol, f"{what}: step {i + 1} {k} {b[k]} vs one "
                  f"device {a[k]} (relative {gap:.3g} > {tol})")
            worst = max(worst, gap)
    return worst


def step_collectives(torch, cfg, state, batch, mesh):
    """One more mesh step under ``CostCounter``: the collectives it
    records, by (kind, group): count and result bytes; wire bytes a device
    by the ring formulas."""
    from repro_torch.launch.cost import CostCounter
    from repro_torch.models import steps
    from repro_torch.sharding import TRAIN_RULES, shard_ctx
    step, _ = steps.make_train_step(cfg)
    with CostCounter() as c, shard_ctx(TRAIN_RULES, mesh):
        step(state, batch)
    torch.cuda.synchronize()
    return tally(c)


def tally(c):
    """A ``CostCounter``'s collectives by (kind, group): count and result
    bytes; and the wire bytes a device by the ring formulas."""
    from repro_torch.launch.cost import collective_bytes
    by: dict = {}
    for kind, nbytes, n in c.collectives:
        row = by.setdefault((kind, n), [0, 0])
        row[0] += 1
        row[1] += nbytes
    wire, _ = collective_bytes(c)
    return by, wire


def mesh_dense_phase(torch, ops, out_dir: Path):
    """(a) qwen2.5-3b at full width and depth, float32 state, bf16 compute:
    the launcher on one device (2 steps) and on (2, 2) (2 steps) over phase
    9's batches, step 1's loss, ce and grad_norm within 1e-2; one more mesh
    step counted; then a float32 copy at 4 layers, one step on each, every
    metric and updated leaf within 1e-5 (leaves by max(1, max |leaf|))."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    runs = {}
    for label, extra, devs in (
            ("one device", ["--steps", "2"], None),
            ("mesh", ["--steps", str(MESH_TRAIN_STEPS), "--mesh",
                      ",".join(map(str, MESH_TRAIN))],
             ["cuda:0"] * math.prod(MESH_TRAIN))):
        log = out_dir / f"mesh-{label.replace(' ', '-')}.jsonl"
        args = train_cli.parse_args(FULL_TRAIN[:2] + FULL_TRAIN[4:] + extra
                                    + ["--log", str(log)])
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            state = train_cli.train(args, mesh_devices=devs)
        torch.cuda.synchronize()
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        per_step = recs[-1]["sec"] / (recs[-1]["step"] - recs[0]["step"])
        runs[label] = (recs, per_step, peak_gib(torch))
        check(all(math.isfinite(v) for r in recs for v in r.values()),
              f"{label}: a metric is not finite: {recs}")
        if label == "one device":
            del state
    (one, one_ms, one_peak), (mesh, mesh_ms, mesh_peak) = (
        runs["one device"], runs["mesh"])
    TRAIN_PEAKS["13 one device, 2 x 256"] = one_peak
    TRAIN_PEAKS[f"13 {MESH_TRAIN} mesh, 2 x 256"] = mesh_peak
    worst = held_metrics(one[:1], mesh[:1], ("loss", "ce", "grad_norm"),
                         MESH_TOL, "qwen2.5-3b (2, 2) vs one device")
    cfg = get_config("qwen2.5-3b")
    batch = train_batches(torch, cfg, MESH_TRAIN_STEPS + 1, seq=256,
                          device="cuda")[-1]
    mesh22 = next(iter(state.params.values())).mesh
    t0 = time.perf_counter()
    by, wire = step_collectives(torch, cfg, state, batch, mesh22)
    counted_s = time.perf_counter() - t0
    del state
    print(f"  (a) qwen2.5-3b, {cfg.n_layers} layers, on {MESH_TRAIN} (every "
          f"position on cuda:0: a collective is a copy within the card), "
          f"{MESH_TRAIN_STEPS} steps of 2 x 256 tokens through the launcher: "
          + "; ".join(f"step {r['step']} loss {r['loss']:.4f} grad_norm "
                      f"{r['grad_norm']:.3f}" for r in mesh)
          + f"; step 1 within {worst:.3g} (<= {MESH_TOL}) of one device's "
          f"(loss {one[0]['loss']:.4f}, grad_norm {one[0]['grad_norm']:.3f})")
    print(f"    host clock a step after the first: mesh {mesh_ms * 1e3:.1f} ms"
          f" against one device {one_ms * 1e3:.1f} ms in this phase (PR 22: "
          f"516.1-533.4); peak {mesh_peak:.2f} GiB against {one_peak:.2f} "
          f"(PR 22: 63.17) ({gpu_line()})")
    print(f"    one step under CostCounter ({counted_s:.1f} s): "
          + "; ".join(f"{n} {kind} over {g} ({b / 1e9:.4f} GB of results)"
                      for (kind, g), (n, b) in sorted(by.items()))
          + f"; {wire / 1e9:.4f} GB on the wire a device by the ring "
          f"formulas")
    gathers, scatters = family_gathers(cfg)
    check(by.get(("all-gather", 2), [0])[0] == gathers
          and by.get(("reduce-scatter", 2), [0])[0] == scatters,
          f"(a) collectives {by}: one data reduce-scatter a weight matrix "
          f"and one all-gather, two a layer's under remat {cfg.remat!r}")
    # float32 compute at 4 layers: one step, every leaf held
    f32 = dataclasses.replace(cfg, n_layers=MESH_SHORT_LAYERS,
                              dtype="float32")
    b1 = train_batches(torch, f32, 1, seq=256, device="cuda")
    one, mesh, _, _, (s1, s2) = mesh_runs(torch, f32, MESH_TRAIN, b1,
                                          keep=("one", "mesh"))
    m_gap = held_metrics(one, mesh, ("loss", "ce", "grad_norm"),
                         MESH_F32_TOL, "float32 (2, 2) vs one device")
    line = held_leaves(torch, s1, s2, "float32 (2, 2)")
    del s1, s2
    print(f"    float32 compute at {MESH_SHORT_LAYERS} layers, one step: "
          f"metrics within {m_gap:.3g}, {line}")


def held_leaves(torch, s1, s2, what) -> str:
    """A one-device state ``s1`` and a mesh state ``s2`` after one float32
    step: every updated leaf (parameters, mu, nu) within 1e-5 of max(1, max
    |leaf|), the parameter elements whose gradient is rounding-sized aside
    (held to AdamW's first-step bound); fails past either → what to print."""
    gaps, noise = {}, [0, 0.0]
    for part, a, b in (("params", dict(s1.params.named_parameters()),
                        s2.params),
                       ("mu", s1.opt_state.mu, s2.opt_state.mu),
                       ("nu", s1.opt_state.nu, s2.opt_state.nu)):
        for k, want in a.items():
            gap = (b[k].full() - want.detach()).abs()
            scale = max(1.0, float(want.abs().max()))
            if part == "params":
                # AdamW's first step moves by lr * g / (|g| + 1e-8): where
                # the gradient is rounding-sized that ratio is not, and
                # such an element may move by up to 2 lr
                g = s1.opt_state.mu[k] / (1 - ADAM_B1)
                noisy = g.abs() < ADAM_NOISE_G
                check(bool((gap[noisy] <= 2 * LR).all()),
                      f"{what}: {k} moved past AdamW's step bound")
                noise[0] += int((gap[noisy] > MESH_F32_TOL * scale).sum())
                noise[1] = max(noise[1], float(gap[noisy].max()) / LR
                               if noisy.any() else 0.0)
                gap = torch.where(noisy, 0.0, gap)
            gaps[f"{part}/{k}"] = float(gap.max()) / scale
    where = max(gaps, key=gaps.get)
    check(gaps[where] <= MESH_F32_TOL, f"{what}: leaf {where} apart "
          f"by {gaps[where]:.3g} > {MESH_F32_TOL}")
    return (f"every updated leaf (parameters, mu, nu) within "
            f"{gaps[where]:.3g} of max(1, max |leaf|) (worst {where}; <= "
            f"{MESH_F32_TOL}), the parameter elements whose gradient is "
            f"under {ADAM_NOISE_G:g} aside: AdamW's first step divides it "
            f"by |g| + 1e-8, and they moved within {noise[1]:.3g} lr (<= "
            f"2), {noise[0]} of them past {MESH_F32_TOL} of their leaf")


def mesh_padded_phase(torch):
    """(b) qwen2.5-14b at full width, 2 of 48 layers, on (1, 16): 40 heads
    pad to 48, 3 a rank; 2 steps of 1 x 256 tokens held to the one-device
    steps within 1e-2 on loss and grad_norm; the effective wo's pad rows
    exactly zero."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.attention import Attention
    from repro_torch.sharding import TRAIN_RULES, shard_ctx
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=PAD_LAYERS)
    batches = [{k: v[:1] for k, v in b.items()} for b in
               train_batches(torch, cfg, 2, seq=256, device="cuda")]
    with shard_ctx(TRAIN_RULES, card_mesh(PAD_MESH)):
        Hp, G, Gp = Attention._padded_heads((0, 0, cfg.n_heads, cfg.hd),
                                            cfg.n_kv_heads)
    one, mesh, ms, peak, (_, state) = mesh_runs(torch, cfg, PAD_MESH,
                                                batches, keep=("mesh",))
    worst = held_metrics(one, mesh, ("loss", "grad_norm"), MESH_TOL,
                         "qwen2.5-14b (1, 16) vs one device")
    pads = 0
    for i in range(cfg.n_layers):
        wo = state.params[f"blocks.{i}.attn.wo.w"].full()
        eff = Attention._wo_padded(wo, cfg.n_kv_heads, G, Gp, cfg.hd)
        pad = eff.reshape(cfg.n_kv_heads, Gp, cfg.hd, -1)[:, G:]
        check(torch.count_nonzero(pad) == 0,
              f"layer {i}: the effective wo's pad rows are not zero")
        pads += pad.numel()
    n = sum(math.prod(t.shape) for t in state.params.values())
    del state
    print(f"  (b) qwen2.5-14b at {cfg.n_layers} of 48 layers ({n / 1e9:.3f} B "
          f"parameters), {cfg.n_heads} heads over {cfg.n_kv_heads} KV pad "
          f"to Hp = {Hp} on {PAD_MESH}, {Hp // PAD_MESH[1]} a rank; "
          + "; ".join(f"step {i + 1} loss {m['loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.3f}" for i, m in enumerate(mesh))
          + f"; within {worst:.3g} (<= {MESH_TOL}) of one device's; "
          f"the {pads} elements of the effective wo's pad rows exactly zero; "
          f"host clock "
          f"a step after the first {ms * 1e3:.1f} ms, peak {peak:.2f} GiB "
          f"({gpu_line()})")


def mesh_elastic_phase(torch, out_dir: Path):
    """(c) qwen2.5-3b at full width, 4 layers: 4 steps on (2, 2), a
    checkpoint, ``elastic_restore`` onto ``ReMesh(1, 4)`` (bitwise the
    saved state), 2 more steps there within 1e-2 of 2 more on (2, 2)."""
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.elastic import (
        ReMesh, elastic_restore, state_shardings,
    )
    from repro_torch.models import steps
    from repro_torch.sharding import TRAIN_RULES, device_put, shard_ctx
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              n_layers=MESH_SHORT_LAYERS)
    batches = train_batches(torch, cfg, 6, seq=256, device="cuda")
    step, (opt_init, _) = steps.make_train_step(cfg)
    mesh = card_mesh(MESH_TRAIN)
    free(torch)
    state = device_put(steps.init_train_state(0, cfg, opt_init,
                                              device="cuda"),
                       state_shardings(cfg, mesh)[0])

    def run(st, bs, fn):
        ms = []
        for b in bs:
            st, m = fn(st, b)
            ms.append({k: float(v) for k, v in m.items()})
        return st, ms

    def on_mesh(st, b):
        with shard_ctx(TRAIN_RULES, mesh):
            return step(st, b)

    state, _ = run(state, batches[:4], on_mesh)
    root = out_dir / "elastic"
    t0 = time.perf_counter()
    CheckpointManager(root).save(state.step, state, blocking=True)
    write_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in (root / "step_4").iterdir())
    t0 = time.perf_counter()
    back, step2, mesh2 = elastic_restore(
        str(root), cfg, ReMesh(data_axis=ELASTIC_MESH[0],
                               model_axis=ELASTIC_MESH[1]),
        devices=["cuda:0"] * math.prod(ELASTIC_MESH))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    for part, a, b in (("params", state.params, back.params),
                       ("mu", state.opt_state.mu, back.opt_state.mu),
                       ("nu", state.opt_state.nu, back.opt_state.nu)):
        for k in a:
            check(torch.equal(a[k].full(), b[k].full()),
                  f"elastic: restored {part}/{k} differs from the saved")
    back, after = run(back, batches[4:], step2)
    del back
    state, cont = run(state, batches[4:], on_mesh)
    del state
    worst = held_metrics(cont, after, ("loss", "ce", "grad_norm"), MESH_TOL,
                         "elastic (1, 4) vs (2, 2)")
    print(f"  (c) elastic, qwen2.5-3b at {cfg.n_layers} layers: 4 steps on "
          f"{MESH_TRAIN}, checkpoint {nbytes / 1e9:.3f} GB written in "
          f"{write_s:.2f} s, restored onto {dict(mesh2.shape)} in "
          f"{read_s:.2f} s (the file cache warm), bitwise the saved state; 2 "
          f"more steps there: "
          + "; ".join(f"loss {m['loss']:.4f}" for m in after)
          + f", within {worst:.3g} (<= {MESH_TOL}) of 2 more on {MESH_TRAIN}"
          f" ({gpu_line()})")


def mesh_moe_phase(torch):
    """(d) olmoe-1b-7b at full width, DEPTH_CUT layers, on (2, 2): a
    dropless copy (EP on the mesh) held to the one-device step within 1e-2;
    at cf 1.25 drop_frac printed beside the one-device step's."""
    import dataclasses
    cut = depth_cut("olmoe-1b-7b")
    batches = train_batches(torch, cut, 1, seq=256, device="cuda")
    E, K = cut.moe.n_experts, cut.moe.top_k
    free_cfg = dataclasses.replace(cut, moe=dataclasses.replace(
        cut.moe, capacity_factor=E / K))
    one, mesh, ms, peak, _ = mesh_runs(torch, free_cfg, MESH_TRAIN, batches)
    worst = held_metrics(one, mesh, ("loss", "ce", "grad_norm"), MESH_TOL,
                         "olmoe dropless (2, 2) vs one device")
    check(mesh[0]["drop_frac"] == 0.0, f"dropless copy dropped {mesh}")
    one_d, mesh_d, _, _, _ = mesh_runs(torch, cut, MESH_TRAIN, batches)
    print(f"  (d) olmoe-1b-7b at {cut.n_layers} of 16 layers on {MESH_TRAIN} "
          f"(EP: {E // MESH_TRAIN[1]} experts a rank), 2 x 256 tokens: "
          f"dropless loss {mesh[0]['loss']:.4f} grad_norm "
          f"{mesh[0]['grad_norm']:.3f} lb_loss {mesh[0]['lb_loss']:.4f}, "
          f"within {worst:.3g} (<= {MESH_TOL}) of one device's (lb_loss "
          f"{one[0]['lb_loss']:.4f}: EP averages the data shards' balance "
          f"losses); at cf {cut.moe.capacity_factor} drop_frac "
          f"{mesh_d[0]['drop_frac']:.4f} on the mesh (capacity per data "
          f"shard) against {one_d[0]['drop_frac']:.4f} on one device "
          f"(printed only); host clock a step {ms * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB")


def train_mesh_phase(torch, ops):
    """Phase 13: training over a mesh laid on the one card (above)."""
    import shutil
    import tempfile
    from repro_torch.kernels import _lib
    print(f"[13] train mesh: the sharded train step on meshes laid on one "
          f"card ({gpu_line()})")
    t0 = time.perf_counter()
    before = ops.launch_counts()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="mesh-", dir=_lib.BUILD_DIR))
    try:
        mesh_dense_phase(torch, ops, out_dir)
        mesh_padded_phase(torch)
        mesh_elastic_phase(torch, out_dir)
        mesh_moe_phase(torch)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    free(torch)
    check(ops.launch_counts() == before,
          f"kernels launched while training: {ops.launch_counts()}")
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- phase 14
# the families phase 13 leaves out, on its (2, 2) mesh laid on cuda:0: each
# at full width, its depth cut so that a float32 state and its one-device
# copy fit beside each other, and the SSM families' tokens cut so that the
# phase stays short (their train scans are per-token loops, run once a
# position: a zamba2 mesh step at 12 layers took 27.7 s at 2 x 256
# tokens on an H100, 5.4 s at 2 x 64): (layers, tokens a row; 2 rows)
FAMILY_CUTS = {"falcon-mamba-7b": (2, 64), "zamba2-2.7b": (12, 64),
               "qwen2-vl-7b": (4, 1280), "seamless-m4t-medium": (None, 256)}
FAMILY_STEPS = 2
FAMILY_F32 = ("falcon-mamba-7b", "zamba2-2.7b")
# zamba2's bf16 gradient is rounding-dominated at these weights: two valid
# roundings of the one-device step (an H100's and a CPU's) part by
# 0.6-2.8% on grad_norm, and bf16 from float32 compute by 1.1-12.4% (up
# to a third on some leaves), so its bf16 grad_norm is printed beside one
# device's and the float32 step's, and held by the float32 copy at 1e-5
BF16_NOISY_GRAD_NORM = ("zamba2-2.7b",)


def family_gathers(cfg) -> tuple[int, int]:
    """The (all-gathers, reduce-scatters) over 2 of one (2, 2) mesh step:
    the table (and an untied readout) once, and each weight split over
    "data" once a layer, ``in_proj`` twice (over "data", then over "model"
    whole or, with fewer rows than d_model as here, each rank's product:
    ``mamba.project_columns``), a shared block once however many groups
    read it; each gather's backward a reduce-scatter.  Under ``remat``
    ("full", the configs' default) each layer or hybrid group is one
    checkpoint: it gathers its weights itself (a shared block once a
    group) and its recompute gathers them again."""
    again = cfg.remat != "none"
    if cfg.enc_dec:
        outer, layers = 1, 7 * cfg.n_enc_layers + 11 * cfg.n_layers
    elif cfg.hybrid is not None:
        G = cfg.n_layers // cfg.hybrid.attn_every
        shared = G if again else min(G, cfg.hybrid.n_shared_blocks)
        outer, layers = 1, 5 * cfg.n_layers + 7 * shared + G
    elif cfg.ssm is not None:
        outer, layers = 1, 3 * cfg.n_layers
    else:
        # an untied readout (qwen2-vl-7b) is gathered as the table is
        outer = 1 + (0 if cfg.tie_embeddings else 1)
        layers = 7 * cfg.n_layers
    return outer + (1 + again) * layers, outer + layers


def on_card(torch, state, what):
    """Every block of a mesh state lies on the card: nothing fell back."""
    for part in (state.params, state.opt_state.mu, state.opt_state.nu):
        for k, leaf in part.items():
            for pos, blk in leaf.blocks.items():
                check(blk.device.type == "cuda",
                      f"{what}: {k} at {pos} lies on {blk.device}")


def family_run(torch, arch):
    """One family at ``FAMILY_CUTS[arch]`` on (2, 2): 2 steps beside one
    device's; for the SSM families the float32 copy, its mesh step counted
    (a bf16 counted step took 14 s of zamba2's 43: the scans' ops under
    the counter), for the others one more bf16 mesh step counted."""
    import dataclasses
    from repro_torch.configs import get_config
    layers, seq = FAMILY_CUTS[arch]
    cfg = get_config(arch)
    full = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batches = train_batches(torch, cfg, FAMILY_STEPS + 1, seq=seq,
                            device="cuda")
    f32 = arch in FAMILY_F32
    stats: dict = {}
    t0 = time.perf_counter()
    one, mesh, _, _, (_, state) = mesh_runs(
        torch, cfg, MESH_TRAIN, batches[:FAMILY_STEPS],
        keep=() if f32 else ("mesh",), stats=stats)
    clocks = {"2 + 2 steps": time.perf_counter() - t0}
    check(all(math.isfinite(v) for m in one + mesh for v in m.values()),
          f"{arch}: a metric is not finite: {one} {mesh}")
    worst = held_metrics(one[:1], mesh[:1], ("loss", "ce"), MESH_TOL,
                         f"{arch} (2, 2) vs one device")
    depth = (f"{cfg.n_enc_layers} + {cfg.n_layers} layers" if cfg.enc_dec
             else f"{cfg.n_layers} of {full} layers")
    extra = (f", {cfg.n_vision_patches} of them patch rows"
             if cfg.family == "vlm" else ", frames of as many rows"
             if cfg.enc_dec else "")
    (one_s, one_peak), (mesh_s, mesh_peak) = stats["one"], stats["mesh"]
    print(f"  {arch} at full width, {depth}, on {MESH_TRAIN}, 2 x {seq} "
          f"tokens{extra}: "
          + "; ".join(f"step {i + 1} loss {m['loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.3f}" for i, m in enumerate(mesh))
          + f"; step 1's loss and ce within {worst:.3g} (<= {MESH_TOL}) of "
          f"one device's (loss {one[0]['loss']:.4f}, grad_norm "
          f"{one[0]['grad_norm']:.3f}) ({gpu_line()})")
    print(f"    host clock a step after the first: mesh {mesh_s * 1e3:.1f} "
          f"ms against one device {one_s * 1e3:.1f} ms ({mesh_s / one_s:.2f}"
          f"x); peak {mesh_peak:.2f} GiB against {one_peak:.2f} "
          f"({gpu_line()})")
    f32_norm = None
    if f32:
        t0 = time.perf_counter()
        counted: dict = {}
        one32, mesh32, _, _, (s1, s2) = mesh_runs(
            torch, dataclasses.replace(cfg, dtype="float32"), MESH_TRAIN,
            batches[:1], keep=("one", "mesh"), stats=counted, count=True)
        by, wire = tally(counted["counter"])
        m_gap = held_metrics(one32, mesh32, ("loss", "ce", "grad_norm"),
                             MESH_F32_TOL,
                             f"{arch} float32 (2, 2) vs one device")
        on_card(torch, s2, f"{arch} float32")
        line = held_leaves(torch, s1, s2, f"{arch} float32 (2, 2)")
        del s1, s2
        free(torch)
        clocks["float32, counted"] = time.perf_counter() - t0
        f32_norm = one32[0]["grad_norm"]
        print(f"    float32 compute at the same cut, one step: metrics "
              f"within {m_gap:.3g} (<= {MESH_F32_TOL}), {line} "
              f"({gpu_line()})")
        what = "the float32 copy's mesh step under CostCounter"
    else:
        on_card(torch, state, arch)
        mesh22 = next(iter(state.params.values())).mesh
        t0 = time.perf_counter()
        by, wire = step_collectives(torch, cfg, state, batches[-1], mesh22)
        clocks["counted"] = time.perf_counter() - t0
        del state
        free(torch)
        what = "one more mesh step under CostCounter"
    gathers, scatters = family_gathers(cfg)
    check(by.get(("all-gather", 2), [0])[0] == gathers
          and by.get(("reduce-scatter", 2), [0])[0] == scatters,
          f"{arch}: collectives {by}: {gathers} data all-gathers and "
          f"{scatters} reduce-scatters expected")
    print(f"    {what}: "
          + "; ".join(f"{n} {kind} over {g} ({nb / 1e9:.4f} GB of results)"
                      for (kind, g), (n, nb) in sorted(by.items()))
          + f"; {wire / 1e9:.4f} GB on the wire a device by the ring "
          f"formulas ({gathers} data all-gathers and {scatters} "
          f"reduce-scatters, as the layout and remat {cfg.remat!r} "
          f"imply)")
    a, b = one[0]["grad_norm"], mesh[0]["grad_norm"]
    gap = rel_gap(b, a)
    if arch in BF16_NOISY_GRAD_NORM:
        print(f"    step 1's bf16 grad_norm {b:.4f}, {gap:.3g} from one "
              f"device's {a:.4f}; the float32 step's {f32_norm:.4f} (one "
              f"device's bf16 {rel_gap(a, f32_norm):.3g} from it, the "
              f"mesh's {rel_gap(b, f32_norm):.3g}): printed, held by the "
              f"float32 copy ({gpu_line()})")
    else:
        check(gap <= MESH_TOL, f"{arch}: step 1 grad_norm {b} vs one "
              f"device {a} (relative {gap:.3g} > {MESH_TOL})")
        print(f"    step 1's grad_norm {b:.4f} within {gap:.3g} (<= "
              f"{MESH_TOL}) of one device's ({gpu_line()})")
    print("    clocks: " + ", ".join(f"{k} {v:.1f} s"
                                      for k, v in clocks.items()))


def train_mesh_families_phase(torch, ops):
    """Phase 14: the SSM, hybrid, VLM and encoder-decoder families trained
    over a mesh laid on the one card (above)."""
    print(f"[14] train mesh families: the sharded train step of the SSM, "
          f"hybrid, VLM and encoder-decoder families on {MESH_TRAIN} laid "
          f"on one card ({gpu_line()})")
    t0 = time.perf_counter()
    before = ops.launch_counts()
    for arch in FAMILY_CUTS:
        t1 = time.perf_counter()
        family_run(torch, arch)
        free(torch)
        print(f"    ({arch}: {time.perf_counter() - t1:.1f} s)")
    check(ops.launch_counts() == before,
          f"kernels launched while training: {ops.launch_counts()}")
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- phase 15
# the dry-run on the production mesh: (a) the serve partition at full width
# on a (2, 2) mesh laid on cuda:0 beside the one-device steps, (b) lone
# positions of the production meshes at full width and depth, (c) the
# training peaks under remat
SERVE_MESH = (2, 2)
SERVE_PROMPT, SERVE_RING = 512, 1024         # (a): 2 prompts of 512 tokens
SERVE_ROWS, SERVE_STEPS = 8, 2               # decode: 8 rows, 2 steps
# bf16: every rank's partial products of wo and the MLP's down projection
# round to bf16 before the psum adds them, where one device's product
# rounds once, so logits part by rounding (0.0906 at 2 x 512 on the
# H100), the K/V caches by 0.1094 after the prefill and 0.1211 after 4
# decode steps: both held to phases 11-12's AXIS_GAP; a float32 copy at
# SERVE_F32_LAYERS holds the partition itself to AXIS_F32_TOL x max(1,
# max |logit|), its caches to AXIS_F32_TOL x max(1, max |K/V|)
SERVE_F32_LAYERS = 4
# timed steps of a lone cell after the counted one (one: the time limit)
LONE_REPS = 1
LONE_CELLS = (("qwen2.5-3b", "decode_32k", "single"),
              ("qwen2.5-3b", "prefill_32k", "single"),
              ("qwen2.5-3b", "train_4k", "single"),
              ("qwen2.5-3b", "decode_32k", "multi"),
              ("qwen2-72b", "decode_32k", "single"),
              ("phi3.5-moe-42b-a6.6b", "decode_32k", "single"))
# (c): one device, one train step's loss and gradients, (rows, tokens) and
# the remat values run there; without remat 2 x 2048 runs out of the
# card's memory (the chunked attention's saved scores, 36 layers)
REMAT_RUNS = (((2, 256), ("none", "full")), ((2, 1024), ("none", "full")),
              ((2, 2048), ("full",)))
# the peaks PRs measured without remat (PERF.md): phase 9's one device and
# phase 13's (2, 2) mesh at 2 x 256
NO_REMAT_PEAKS = {"9": 63.17, "13 mesh": 52.57}
# (c): phase 9's whole step timed under each remat, this many a turn (one:
# the time limit)
REMAT_STEP_REPS = 1


def cache_leaves(tree) -> dict:
    """{path: leaf} of a cache tree, "index" aside."""
    from repro_torch.sharding import shard_map as sm
    return {k: v for k, v in sm.tree_leaves(tree).items() if k != "index"}


def held_lone(torch, step, args_of, mesh, full, label):
    """The collective records of a lone position's run equal the full
    mesh run's (``full``), at the first and the last position."""
    from repro_torch.launch.cost import CostCounter
    from repro_torch.sharding import shard_ctx
    from repro_torch.sharding import shard_map as sm
    rules = full["rules"]
    for pos in (sm.positions(mesh)[0], sm.positions(mesh)[-1]):
        lone = sm.LoneMesh(mesh, pos)
        with shard_ctx(rules, lone), CostCounter() as c:
            step(*args_of(lone))
        check(c.collectives == full["counter"].collectives,
              f"{label}: the lone position {pos} recorded "
              f"{len(c.collectives)} collectives, the full run "
              f"{len(full['counter'].collectives)}, or they differ")
        check(c.kernels == {k: {**v, "calls": v["calls"] // mesh.size,
                                "flops": v["flops"] // mesh.size,
                                "bytes": v["bytes"] // mesh.size,
                                "transcendentals":
                                    v["transcendentals"] // mesh.size}
                            for k, v in full["counter"].kernels.items()},
              f"{label}: the lone position {pos}'s kernel regions "
              f"{c.kernels} are not a {mesh.size}th of the full run's")


def cache_gaps(c1, c2) -> dict:
    """{leaf: (the largest gap between the one-device cache ``c1`` and the
    laid out ``c2``, gathered whole; max |leaf| of ``c1``)} over every leaf
    but "index".  A wrong layout, ring slot or state parts them by the size
    of an entry."""
    got = cache_leaves(c2)
    out = {}
    for path, a in cache_leaves(c1).items():
        a = a.float()
        out[path] = (float((a - got[path].full().float()).abs().max()),
                     float(a.abs().max()))
    return out


def cache_gap(c1, c2, tol, relative):
    """(the largest gap of ``cache_gaps`` over the leaves, each leaf's
    within its limit): ``tol``, times max(1, the leaf's max |entry|) where
    ``relative``, as the logits are held."""
    gaps = cache_gaps(c1, c2)
    return (max(g for g, _ in gaps.values()),
            all(g <= tol * (max(1.0, t) if relative else 1.0)
                for g, t in gaps.values()))


def leaf_line(c1, c2) -> str:
    """Each leaf's gap beside its max |entry|, for the output."""
    return ", ".join(f"{k} {g:.4g} (max {t:.4g})"
                     for k, (g, t) in cache_gaps(c1, c2).items())


def prefill_kernels(cfg) -> dict:
    """The kernels one device's prefill launches: K4 on each causal
    attention layer (a decoder layer, a shared block's application; the
    encoder is plain), K7 on each Mamba2 layer; Mamba1's scan is plain."""
    if cfg.hybrid is not None:
        return {"ssm_scan": cfg.n_layers,
                "flash_attention": cfg.n_layers // cfg.hybrid.attn_every}
    if cfg.ssm is not None:
        return {"ssm_scan": cfg.n_layers} if cfg.ssm.version == 2 else {}
    return {"flash_attention": cfg.n_layers}


def family_inputs(torch, cfg, rng, B, S):
    """A prefill's inputs at (B, S) from ``rng``, on the card: the tokens,
    and the family's patches (B, P, d_model) or frames (B, S, d_model) in
    the compute dtype."""
    import numpy as np
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).cuda()}
    extra = {"patches": (B, cfg.n_vision_patches, cfg.d_model)
             if cfg.family == "vlm" else None,
             "frames": (B, S, cfg.d_model) if cfg.enc_dec else None}
    for name, shape in extra.items():
        if shape is not None:
            batch[name] = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(cfg.cdtype)
    return batch


def witness_gaps(one, mesh_, truth) -> dict:
    """{leaf: (one device's gap to the float32 witness, the mesh's)} of
    the logits (a tensor each) or of every cache leaf but "index"."""
    def gaps(a, b, t):
        t = t.float()
        return (float((a.float() - t).abs().max()),
                float((b.float() - t).abs().max()))
    if not isinstance(truth, dict):
        return {"logits": gaps(one, mesh_, truth)}
    got, one = cache_leaves(mesh_), cache_leaves(one)
    return {path: gaps(one[path], got[path].full(), t)
            for path, t in cache_leaves(truth).items()}


def witness_held(gaps: dict) -> bool:
    """Each of ``witness_gaps``' leaves: the mesh's gap to the witness
    within WITNESS_RATIO × one device's (an integer leaf exact where one
    device is)."""
    return all(m <= WITNESS_RATIO * o for o, m in gaps.values())


def witness_line(gaps: dict) -> str:
    return ", ".join(f"{k} {o:.4g} / {m:.4g}" for k, (o, m) in gaps.items())


def serve_mesh_run(torch, ops, cfg, counts, label, tol=AXIS_GAP,
                   relative=False, *, prompt=SERVE_PROMPT, ring=SERVE_RING,
                   decode_prompt=SERVE_PROMPT // 2, witness=False,
                   lone=True):
    """(a) one config at full width, bf16 weights: the one-device prefill
    (2 prompts of ``prompt`` tokens, and the family's patches or frames,
    into a ``ring``-slot ring) and SERVE_STEPS decode steps of SERVE_ROWS
    rows (prefilled with ``decode_prompt`` tokens) beside the partitioned
    steps over the weights laid out on SERVE_MESH on cuda:0 under
    ``serve_rules``, fed the same tokens: logits within ``tol`` (×
    max(1, max |logit|) where ``relative``), every cache leaf by the same
    rule at its own scale (``cache_gap``); with
    ``witness`` instead the bf16 logits and cache leaves of the mesh and of
    one device against the one-device steps of a float32 copy of the same
    weights fed the same tokens, the mesh's gap within WITNESS_RATIO × one
    device's (``witness_gaps``); the prefill's kernels
    (``prefill_kernels``) on each position counted into ``counts``, no
    decode kernel; with ``lone`` the lone positions' collective records
    held to the full run's."""
    import numpy as np
    from repro_torch.launch.cost import CostCounter, collective_bytes
    from repro_torch.launch.dryrun import serve_config
    from repro_torch.models import LM
    from repro_torch.models.steps import (
        make_decode_step, make_prefill_step, serve_shardings,
    )
    from repro_torch.sharding import device_put, serve_rules, shard_ctx
    from repro_torch.sharding import shard_map as sm
    mesh = card_mesh(SERVE_MESH)
    model = LM(serve_config(cfg), device="cuda", seed=0)
    rng = np.random.default_rng(7)
    want = {k: n * mesh.size for k, n in prefill_kernels(cfg).items()}
    rule = f"{tol} x {'max(1, max |leaf|)' if relative else '1'}"
    model32 = None
    if witness:         # the same weights in float32, computed in float32
        import dataclasses
        model32 = LM(dataclasses.replace(cfg, dtype="float32",
                                         param_dtype="float32"),
                     device="cuda", seed=0)
        with torch.no_grad():
            for p32, p in zip(model32.parameters(), model.parameters()):
                p32.copy_(p.float())
        model32.recast()
    out = {}
    for what, B, S in (("prefill", 2, prompt),
                       ("decode", SERVE_ROWS, decode_prompt)):
        batch = family_inputs(torch, cfg, rng, B, S)
        rules = serve_rules(B)
        params = device_put(model, serve_shardings(cfg, mesh, rules))
        pre = make_prefill_step(cfg, ring)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, c1 = pre(model, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        mesh_counts: dict = {}
        with shard_ctx(rules, mesh), launches_into(ops, mesh_counts), \
                CostCounter() as counter:
            l2, c2 = pre(params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = peak_gib(torch)
        for k, n in mesh_counts.items():
            counts[k] = counts.get(k, 0) + n
        check(mesh_counts == want, f"{label} mesh prefill launched "
              f"{mesh_counts}, expected {want} (a layer's on each position)")
        bound = tol * (max(1.0, float(l1.float().abs().max()))
                       if relative else 1.0)
        gap = float((l1.float() - l2.float()).abs().max())
        kv_gap, kv_ok = cache_gap(c1, c2, tol, relative)
        if witness:
            l32, c32 = pre(model32, batch)
            wit = {**witness_gaps(l1, l2, l32), **witness_gaps(c1, c2, c32)}
            check(witness_held(wit), f"{label} mesh prefill of {B} x {S}, "
                  f"one device / the mesh against the float32 witness: "
                  f"{witness_line(wit)} (the mesh within {WITNESS_RATIO} x "
                  f"one device)")
        else:
            check(gap <= bound, f"{label} mesh prefill of {B} x {S} logits "
                  f"{gap:.4g} from the one-device step's (> {bound:.4g})")
            check(kv_ok, f"{label} mesh prefill's caches from the "
                  f"one-device step's: {leaf_line(c1, c2)} (limit {rule})")
        held = (f"one device / the mesh against the float32 witness "
                f"{witness_line(wit)} (the mesh within {WITNESS_RATIO} x "
                f"one device); " if witness else "")
        specs = {k: v.spec for k, v in cache_leaves(c2).items()}
        if what == "prefill":
            if lone:
                held_lone(torch, pre, lambda lone: (
                    sm.lone_tree(params, lone), batch),
                    mesh, {"rules": rules, "counter": counter},
                    f"{label} prefill")
            wire, detail = collective_bytes(counter)
            print(f"  (a) {label} prefill of 2 x {S} tokens on "
                  f"{SERVE_MESH} (every position on cuda:0): logits within "
                  f"{gap:.4g} (max |logit| "
                  f"{float(l1.float().abs().max()):.3f}) of the one-device "
                  f"step's, the caches within {kv_gap:.4g} ("
                  f"{leaf_line(c1, c2)}); {held or f'limits {bound:.4g}, {rule}; '}laid out "
                  f"{specs}); kernels {mesh_counts} on each "
                  f"position's heads; host clock {(t2 - t1) * 1e3:.1f} ms "
                  f"(under the cost counter) against one device "
                  f"{(t1 - t0) * 1e3:.1f} ms; peak {peak:.2f} GiB; "
                  f"collectives {detail['counts']}, {wire:.0f} wire bytes "
                  f"a device" + ("; the lone first and last positions "
                                 "record the same collectives" if lone
                                 else ""), flush=True)
            out[what] = gap
            continue
        dec = make_decode_step(cfg)
        gaps, one_s, mesh_s = [], [], []
        tok = torch.argmax(l1[:, -1].float(), dim=-1).to(torch.int32)[:, None]
        c1["index"] = c1["index"].reshape(())
        if witness:
            c32["index"] = c32["index"].reshape(())
            wit = {}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(SERVE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d1, c1 = dec(model, tok, c1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_counts: dict = {}
            with shard_ctx(rules, mesh), launches_into(ops, step_counts):
                d2, c2 = dec(params, tok, c2)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(not step_counts, f"{label} mesh decode launched "
                  f"{step_counts}: the decode bodies are plain ops")
            gaps.append(float((d1.float() - d2.float()).abs().max()))
            if witness:
                d32, c32 = dec(model32, tok, c32)
                wit["logits"] = tuple(map(max, zip(
                    witness_gaps(d1, d2, d32)["logits"],
                    wit.get("logits", (0.0, 0.0)))))
            one_s.append(t1 - t0)
            mesh_s.append(t2 - t1)
            tok = torch.argmax(d1[:, -1].float(), dim=-1).to(
                torch.int32)[:, None]
        peak = peak_gib(torch)
        kv_gap, kv_ok = cache_gap(c1, c2, tol, relative)
        if witness:
            wit.update(witness_gaps(c1, c2, c32))
            check(witness_held(wit), f"{label} mesh decode, one device / "
                  f"the mesh against the float32 witness: "
                  f"{witness_line(wit)} (the mesh within {WITNESS_RATIO} x "
                  f"one device)")
        else:
            check(max(gaps) <= bound, f"{label} mesh decode logits {gaps} "
                  f"from the one-device step's (> {bound:.4g})")
            check(kv_ok, f"{label} mesh decode's caches from the one-device "
                  f"run's: {leaf_line(c1, c2)} (limit {rule})")
        held = (f"one device / the mesh against the float32 witness "
                f"{witness_line(wit)} (the mesh within {WITNESS_RATIO} x "
                f"one device); " if witness else "")
        with shard_ctx(rules, mesh), CostCounter() as counter:
            dec(params, tok, sm.clone_tree(c2))
        if lone:
            held_lone(torch, dec, lambda lone: (
                sm.lone_tree(params, lone), tok,
                sm.lone_tree(c2, lone, clone=True)),
                mesh, {"rules": rules, "counter": counter},
                f"{label} decode")
        wire, detail = collective_bytes(counter)
        print(f"  (a) {label} decode, {B} rows over a {ring}-slot ring "
              f"(self-attention split-K over \"model\"; {specs}), "
              f"{SERVE_STEPS} steps fed the one-device run's tokens: "
              f"logits within {max(gaps):.4g}, the caches within "
              f"{kv_gap:.4g} ({leaf_line(c1, c2)}); "
              f"{held or f'limits {bound:.4g}, {rule}; '}"
              f"no decode kernel launched "
              f"(the decode bodies are plain ops); host clock a step "
              f"{statistics.median(mesh_s) * 1e3:.1f} ms against one "
              f"device {statistics.median(one_s) * 1e3:.1f} ms; peak "
              f"{peak:.2f} GiB; collectives {detail['counts']}, "
              f"{wire:.0f} wire bytes a device" + (
                  "; the lone positions record the same collectives"
                  if lone else ""), flush=True)
        out[what] = max(gaps)
        del c1, c2
        if witness:
            del c32
    del model, params, model32
    free(torch)
    return out


def lone_cells_phase(torch, ops, counts, cells=None):
    """(b) lone positions of the production meshes at full width and
    depth (``launch.dryrun.analyze_mesh_cell``): each cell's per-device
    FLOPs, bytes, wire bytes (the largest sources by collective size),
    ``step_s`` (the position's compute), peak and roofline terms
    (``RooflineDB`` reading the records with chips 256 or 512); a prefill
    launches ``prefill_kernels`` a step, a decode no kernel."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.dryrun import (
        analyze_mesh_cell, cell_path, production_mesh,
    )
    from repro_torch.models import SHAPES
    from repro_torch.sim import RooflineDB
    out_dir = Path(tempfile.mkdtemp(prefix="lone-", dir=_lib.BUILD_DIR))
    try:
        for arch, shape_name, tag in cells or LONE_CELLS:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            mesh = production_mesh(tag, "cuda")
            t0 = time.perf_counter()
            cell_counts: dict = {}
            with launches_into(ops, cell_counts):
                rec = analyze_mesh_cell(cfg, shape, mesh, "cuda",
                                        reps=LONE_REPS)
            wall = time.perf_counter() - t0
            for k, n in cell_counts.items():
                counts[k] = counts.get(k, 0) + n
            want = prefill_kernels(cfg) if shape.kind == "prefill" else {}
            check(rec["launches"] == want, f"{arch} {shape_name} {tag}: "
                  f"launches a step {rec['launches']}, expected {want}")
            cell_path(out_dir, arch, shape_name, tag).write_text(
                json.dumps(rec, indent=1))
            t = RooflineDB(out_dir).terms(arch, shape_name, tag)
            chips = {"single": 256, "multi": 512}[tag]
            check(t.measured and t.chips == chips
                  and t.flops == rec["cost"]["flops"],
                  f"{arch} {shape_name} {tag}: the DB read {t}")
            runs = ", ".join(f"{x * 1e3:.2f}" for x in rec["step_s_runs"])
            kern = ("; no kernel launched: the decode bodies are plain ops"
                    if shape.kind == "decode" else
                    "; no kernel on the train route" if shape.kind ==
                    "train" else f"; kernels {rec['launches']} a step")
            top = "; ".join(f"{n} x {k} of {b} B over {g}: {w:.4e} B"
                            for k, b, g, n, w in rec["collective_sizes"][:4])
            print(f"  (b) {arch} {shape_name} on {tag} {rec['mesh']} "
                  f"(chips {rec['chips']}), lone position "
                  f"{rec['lone_position']}, {rec['replica_batch']} rows: "
                  f"{rec['cost']['flops']:.4e} FLOPs, "
                  f"{rec['cost']['bytes']:.4e} bytes, "
                  f"{rec['collective_bytes']:.4e} wire bytes a device "
                  f"({rec['collective_detail']['counts']}; the most: "
                  f"{top}); step_s "
                  f"{rec['step_s'] * 1e3:.2f} ms (runs {runs}; compute "
                  f"alone, no wire); peak "
                  f"{(rec['peak_bytes'] or 0) / 2**30:.2f} GiB; roofline compute "
                  f"{t.t_compute * 1e3:.3f} ms, memory "
                  f"{t.t_memory * 1e3:.3f} ms, collective "
                  f"{t.t_collective * 1e3:.3f} ms ({t.bottleneck}), "
                  f"step_s {rec['step_s'] / t.step_time:.2f} x the "
                  f"roofline{kern}; {wall:.1f} s ({gpu_line()})",
                  flush=True)
            free(torch)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def remat_peaks_phase(torch, ops):
    """(c) the training peaks under remat: phases 9's and 13's (the
    configs' remat "full") beside the peaks measured without it; then one
    device's loss and gradients at full width, remat "none" and "full" on
    the same batch at 2 x 256 (phase 9's) and 2 x 1024, "full" at 2 x
    2048 (REMAT_RUNS): peak, host clock, gradients bitwise equal at 2 x
    256."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM, steps
    for k, v in TRAIN_PEAKS.items():
        print(f"  (c) phase {k}: peak {v:.2f} GiB under remat \"full\"")
    print(f"  (c) without remat (PERF.md): phase 9 {NO_REMAT_PEAKS['9']:.2f} "
          f"GiB, phase 13's mesh {NO_REMAT_PEAKS['13 mesh']:.2f} GiB")
    cfg = get_config("qwen2.5-3b")
    model = LM(cfg, device="cuda", seed=0)
    before = ops.launch_counts()
    grads = {}
    for (rows, seq), remats in REMAT_RUNS:
        batch = train_batches(torch, cfg, 1, seq=seq, device="cuda")[0]
        batch = {k: v[:rows] for k, v in batch.items()}
        both = (rows, seq) == REMAT_RUNS[0][0]
        for remat in remats:
            model.cfg = dataclasses.replace(cfg, remat=remat)
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (loss, _), g = steps.loss_and_grads(model, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if both:        # held on the host: the next peak is its own
                grads[remat] = {k: t.cpu() for k, t in g.items()}
            print(f"  (c) qwen2.5-3b loss and gradients, one device, "
                  f"{rows} x {seq} tokens, remat {remat!r}: peak "
                  f"{peak_gib(torch):.2f} GiB, host clock "
                  f"{wall * 1e3:.1f} ms, loss {float(loss):.4f} "
                  f"({gpu_line()})", flush=True)
            del g
    same = all(torch.equal(grads["none"][k], grads["full"][k])
               for k in grads["none"])
    check(same, "remat \"full\" gradients differ from \"none\"'s")
    print(f"  (c) remat \"full\" gradients bitwise equal to \"none\"'s at "
          f"{REMAT_RUNS[0][0][0]} x {REMAT_RUNS[0][0][1]}")
    del grads
    remat_step_clock(torch, model, cfg)
    model.cfg = cfg
    del model
    free(torch)
    check(ops.launch_counts() == before,
          f"kernels launched while training: {ops.launch_counts()}")


def remat_step_clock(torch, model, cfg):
    """(c) phase 9's whole step (the loss, its gradients, clipping and
    AdamW) at its 2 x 256 on one batch, remat "none", "full", "full",
    "none": REMAT_STEP_REPS timed steps each after a warm one, the host
    clock a step of each remat (the median), beside PERF.md's prediction
    of +25-35% for "full"."""
    import dataclasses
    from repro_torch.models import steps
    step, (opt_init, _) = steps.make_train_step(cfg, lr=FULL_TRAIN_LRS[-1])
    state = steps.TrainState(
        model, opt_init(dict(model.named_parameters())), 0)
    rows, seq = REMAT_RUNS[0][0]
    batch = train_batches(torch, cfg, 1, seq=seq, device="cuda")[0]
    batch = {k: v[:rows] for k, v in batch.items()}
    clock: dict = {"none": [], "full": []}
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    for remat in ("none", "full", "full", "none"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        state, m = step(state, batch)
        torch.cuda.synchronize()
        for _ in range(REMAT_STEP_REPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            clock[remat].append(time.perf_counter() - t0)
    check(math.isfinite(float(m["loss"])), f"the step's loss {m['loss']}")
    none_s, full_s = (statistics.median(clock[r]) for r in ("none", "full"))
    print(f"  (c) phase 9's step (AdamW besides), one device, {rows} x "
          f"{seq} tokens: host clock a step {none_s * 1e3:.1f} ms under "
          f"remat 'none', {full_s * 1e3:.1f} ms under 'full' "
          f"({(full_s / none_s - 1) * 100:+.1f}%; predicted +25-35%); "
          f"runs (ms) none {[round(t * 1e3, 1) for t in clock['none']]}, "
          f"full {[round(t * 1e3, 1) for t in clock['full']]}; peak "
          f"{peak_gib(torch):.2f} GiB ({gpu_line()})", flush=True)
    del state, m
    free(torch)


def mesh_dryrun_phase(torch, ops, add):
    """Phase 15: the dry-run on the production mesh (above)."""
    from repro_torch.configs import get_config
    print(f"[15] mesh dry-run: the serve partition, lone positions of the "
          f"production meshes, remat ({gpu_line()})")
    t0 = time.perf_counter()
    counts: dict = {}
    import dataclasses
    qwen = get_config("qwen2.5-3b")
    serve_mesh_run(torch, ops, qwen, counts, "qwen2.5-3b")
    serve_mesh_run(torch, ops, dataclasses.replace(
        qwen, n_layers=SERVE_F32_LAYERS, dtype="float32"), counts,
        f"qwen2.5-3b float32 at {SERVE_F32_LAYERS} layers",
        tol=AXIS_F32_TOL, relative=True)
    olmoe = depth_cut("olmoe-1b-7b")
    # dropless: the expert-parallel body's capacity is a data shard's, the
    # one device's the batch's; with no drop the two compute the same.  In
    # float32: in bf16 a rounding-sized change of the router's logits
    # flips a token's top 8 of 64 experts (0.243 apart at 4 layers on the
    # H100), so bf16 would hold only near-ties
    olmoe = dataclasses.replace(olmoe, dtype="float32",
                                moe=dataclasses.replace(
        olmoe.moe, capacity_factor=float(olmoe.moe.n_experts)))
    serve_mesh_run(torch, ops, olmoe, counts,
                   f"olmoe-1b-7b float32 at {olmoe.n_layers} layers, "
                   f"dropless", tol=AXIS_F32_TOL, relative=True)
    lone_cells_phase(torch, ops, counts)
    remat_peaks_phase(torch, ops)
    add(counts)
    print(f"  phase 15 kernels {counts}: {time.perf_counter() - t0:.1f} s")


# phase 16: the serve partition of the other four families.  (a) each on
# SERVE_MESH laid on cuda:0 beside the one-device steps, full width, bf16:
# arch → (layers, prompt tokens, ring, the decode rows' prompt); depth cut
# to keep the whole run inside its time limit (zamba2 at two hybrid
# groups, both shared blocks), qwen2-vl at 2 x VL_PROMPT tokens (its 1024
# patch rows) into a VL_MAX_SEQ ring, seamless at full depth, 2 x 512
# frames and tokens
FAMILY_SERVE = {
    "zamba2-2.7b": (12, SERVE_PROMPT, SERVE_RING, SERVE_PROMPT // 2),
    "falcon-mamba-7b": (8, SERVE_PROMPT, SERVE_RING, SERVE_PROMPT // 2),
    "qwen2-vl-7b": (4, VL_PROMPT, VL_MAX_SEQ, VL_PROMPT),
    "seamless-m4t-medium": (6, 512, SERVE_RING, SERVE_PROMPT // 2),
}
# FAMILY_BF16_NOTE: in bf16 each rank's partial products round before a
# psum adds them.  qwen2-vl's and seamless's bf16 runs part from one
# device by rounding alone, as phase 15's do (0.12 and 0.11 at most on the
# H100), and are held to AXIS_GAP.  The SSM states carry that rounding
# through every later token and layer: the bf16 mesh parted from one
# device by up to 1.63 on falcon's logits (16 layers) and 12.3 on
# zamba2's h (max |h| 63), where the float32 copies agree to 1e-4.  Two
# bf16 roundings of one model part that far (zamba2's one-device K cache
# lies 2.96 from its float32 copy's, of max 6); what the partition must
# not do is round worse than one device.  So the SSM families' bf16 runs
# are held against the one-device steps of a float32 copy of their
# weights (the witness), fed the same tokens: for the logits and every
# cache leaf, the mesh's largest gap to the witness within WITNESS_RATIO
# x one device's (an integer leaf exact).  Sound partitions read 0.56 to
# 1.26 x one device's on the H100; the one fault this rule found, falcon's
# ranks rounding their x_proj partials, dt among them, to bf16 before the
# psum, read 2.19 x (the logits 1.648 against 0.752; they now sum in
# float32).  The float32 copy holds the partition itself to AXIS_F32_TOL x
# max(1, max |value|).
WITNESS_RATIO = 2.0
FAMILY_WITNESS = ("zamba2-2.7b", "falcon-mamba-7b")
# The float32 copies run SERVE_F32_LAYERS layers (seamless's encoder
# too), zamba2's in FAMILY_F32_GROUPS hybrid groups of 2 Mamba2 layers, so
# both shared blocks are held to AXIS_F32_TOL.  At the config's 6 layers a
# group the float32 mesh parted from one device by 8.9e-4 on the second
# group's K cache at 12 layers (max |K| 5.6) and 4.5e-4 at 6, on the H100;
# one device parts from itself as far (8.8e-4 and 4.7e-4: its 2 rows
# prefilled together against each alone), so that is float32 rounding
# growing with the Mamba2 layers before a cache, where a wrong layout,
# shared block or state parts a leaf by its own size
FAMILY_F32_GROUPS = 2
# (b) lone positions of the production meshes, full width and depth
LONE_FAMILY_CELLS = (("zamba2-2.7b", "decode_32k", "single"),
                     ("zamba2-2.7b", "prefill_32k", "single"),
                     ("zamba2-2.7b", "long_500k", "single"),
                     ("zamba2-2.7b", "decode_32k", "multi"),
                     ("falcon-mamba-7b", "decode_32k", "single"),
                     ("falcon-mamba-7b", "long_500k", "single"),
                     ("qwen2-vl-7b", "decode_32k", "single"),
                     ("qwen2-vl-7b", "prefill_32k", "single"),
                     ("seamless-m4t-medium", "decode_32k", "single"))
LONE_LEFT_OUT = {
    ("falcon-mamba-7b", "prefill_32k"):
        "the Mamba1 scan is a Python loop per token (32768 x 64 layers on "
        "the lone position); it waits for a Mamba1 scan kernel",
    ("seamless-m4t-medium", "prefill_32k"):
        "its plain bidirectional encoder over 32768 frames takes 6.1 s on "
        "the H100, more than the run's 1200 s limit leaves (PERF.md §5)",
}


def family_serve_phase(torch, ops, add):
    """Phase 16: (a) each family's serve partition at full width on
    SERVE_MESH beside one device, bf16 within AXIS_GAP or against the
    float32 witness (FAMILY_WITNESS), and a
    float32 copy held to AXIS_F32_TOL x max(1, max |value|); (b)
    LONE_FAMILY_CELLS through ``lone_cells_phase``; the cells left out
    named with their reason."""
    import dataclasses
    from repro_torch.configs import get_config
    print(f"[16] the serve partition of the SSM, hybrid, VLM and "
          f"encoder-decoder families ({gpu_line()})")
    t0 = time.perf_counter()
    counts: dict = {}
    for arch, (layers, prompt, ring, dprompt) in FAMILY_SERVE.items():
        t1 = time.perf_counter()
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=layers, **(
            {"n_enc_layers": layers} if cfg.enc_dec else {}))
        kw = dict(prompt=prompt, ring=ring, decode_prompt=dprompt)
        # bf16: within AXIS_GAP, or against a float32 witness
        # (FAMILY_BF16_NOTE); the lone positions are held on the float32
        # copy below
        serve_mesh_run(torch, ops, cfg, counts,
                       f"{arch} at {cfg.n_layers} layers",
                       witness=arch in FAMILY_WITNESS, lone=False, **kw)
        n = SERVE_F32_LAYERS
        cut = dict(n_layers=n, dtype="float32")
        if cfg.enc_dec:
            cut["n_enc_layers"] = n
        if cfg.hybrid is not None:      # FAMILY_F32_GROUPS
            cut["hybrid"] = dataclasses.replace(
                cfg.hybrid, attn_every=n // FAMILY_F32_GROUPS)
        f32 = dataclasses.replace(cfg, **cut)
        serve_mesh_run(torch, ops, f32, counts,
                       f"{arch} float32 at {n} layers" + (
                           f" in {FAMILY_F32_GROUPS} hybrid groups"
                           if cfg.hybrid is not None else ""),
                       tol=AXIS_F32_TOL, relative=True, **kw)
        print(f"  (a) {arch}: {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    lone_cells_phase(torch, ops, counts, LONE_FAMILY_CELLS)
    for (arch, shape_name), why in LONE_LEFT_OUT.items():
        print(f"  (b) left out: {arch} {shape_name}: {why}")
    print(f"  (b) {time.perf_counter() - t1:.1f} s", flush=True)
    add(counts)
    print(f"  phase 16 kernels {counts}: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the closed loop's arrivals and of the "
                         "DQN check's transitions and weights")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the check instrumentation phase 7 shares with the tests (no JAX)
    sys.path.insert(0, str(ROOT / "tests"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.sample import sample_noise
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineCore

    resolve_device("cuda")       # TF32 off, as everywhere in the port
    t_start = time.perf_counter()
    try:
        card = gpu_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
        times = {}
        with phase_clock(times, "1 build"):
            _lib.load()
            print(f"[1] build: nvcc {_lib.build_seconds} s")
            if _lib.build_log is None:
                print("  (library reused from an earlier build: no ptxas "
                      "output)")
            for name, regs, st, ld in ptxas_report(_lib.build_log or ""):
                print(f"  ptxas {name}: {regs} registers, spill stores "
                      f"{st} B, spill loads {ld} B")
        with phase_clock(times, "2 kernels"):
            print("[2] kernels against their plain versions")
            rows = kernel_phase(torch, ops, ref, sample_noise)
            attention_shapes_phase(torch, ops, ref, "zamba2-2.7b", 32, 32,
                                   80, seed=13)
            attention_shapes_phase(torch, ops, ref, "olmoe-1b-7b", 16, 16,
                                   128, seed=17)
            attention_shapes_phase(torch, ops, ref, "qwen2-vl-7b", 28, 4,
                                   128, seed=19, Smax=VL_MAX_SEQ,
                                   S=VL_PROMPT)
            attention_shapes_phase(torch, ops, ref, "seamless-m4t-medium",
                                   16, 16, 64, seed=23)
            loop_shapes_phase(torch, ops, ref)
            no_backward_phase(torch, ops)
            print(f"  the kernels at phase 10's lengths ({DRY_LEN} tokens; "
                  f"held against the plain versions at {LONG_LEN})")
            long_rows(torch, ops, ref)
        launches = {name: 0 for name in ops.KERNELS}

        def add(counts):
            for name, n in counts.items():
                launches[name] += n

        with phase_clock(times, "3-5 qwen2.5-3b"):
            print("[3] serve qwen2.5-3b at full width")
            add(serve_phase(torch, ops, serve, SERVE,
                            decoder_launches(N_LAYERS)))
            core = EngineCore(get_config("qwen2.5-3b"), MAX_SEQ, seed=0,
                              device="cuda")
            prompts = shared_prompts(core)
            paged_launches, paged_streams = paged_serve_phase(
                torch, ops, core, prompts)
            add(paged_launches)
            print("[4] greedy streams on the card: qwen2.5-3b")
            full_width_streams_phase(torch, core, prompts, paged_streams)
            streams_phase(torch, ops, "qwen2.5-3b")
            print("[5] where a full-width qwen2.5-3b tick's time goes")
            profile_phase(torch, core, prompts)
            del core
            free(torch)
        with phase_clock(times, "3-5 zamba2-2.7b"):
            print("[3] serve zamba2-2.7b at full width")
            add(serve_phase(torch, ops, serve, ZSERVE, zamba2_launches))
            zcore = EngineCore(get_config("zamba2-2.7b"), MAX_SEQ, seed=0,
                               device="cuda")
            z_launches, z_streams = recurrent_paged_phase(
                torch, ops, zcore, "zamba2-2.7b",
                lambda ticks, prefilled: zamba2_launches(ticks, prefilled,
                                                         paged=True))
            add(z_launches)
            print("[4] greedy streams on the card: zamba2-2.7b")
            recurrent_streams_phase(zcore, "zamba2-2.7b", z_streams)
            streams_phase(torch, ops, "zamba2-2.7b")
            print("[5] where a full-width zamba2-2.7b tick's and admission's "
                  "time goes")
            profile_dense_tick(torch, zcore, "zamba2 dense decode")
            profile_admission(torch, zcore, "zamba2-2.7b", ZAMBA2_KERNELS)
            del zcore
            free(torch)
        with phase_clock(times, "3-5 olmoe-1b-7b"):
            olmoe_phases(torch, ops, serve, EngineCore,
                         depth_cut("olmoe-1b-7b"), add)
        with phase_clock(times, "3-5 falcon-mamba-7b"):
            falcon_phases(torch, ops, serve, EngineCore,
                          depth_cut("falcon-mamba-7b"), add)
        with phase_clock(times, "3-5 qwen2-vl-7b"):
            vlm_phases(torch, ops, serve, EngineCore,
                       get_config("qwen2-vl-7b"), add)
        with phase_clock(times, "3-5 seamless-m4t-medium"):
            encdec_phases(torch, ops, EngineCore,
                          get_config("seamless-m4t-medium"), add)
        with phase_clock(times, "6 loop"):
            loop = loop_phase(torch, ops, args.seed, add)
        with phase_clock(times, "7 learning"):
            learning_phase(torch, ops, args.seed, add, loop)
            free(torch)
        with phase_clock(times, "8 fleet"):
            fleet_phase(torch, ops, args.seed, loop)
            # phase 11 holds its sharded loop to phase 6's run
            loop = {"cfg": loop["cfg"], "lc": loop["lc"], "planner": {
                k: loop["planner"][k] for k in ("logs", "streams",
                                                "step_ms")}}
            free(torch)
        with phase_clock(times, "9 train"):
            train_phase(torch, ops, add)
        with phase_clock(times, "10 cost model"):
            cost_model_phase(torch, ops, add)
        with phase_clock(times, "11 fabric"):
            fabric_phase(torch, ops, loop, args.seed, add)
            del loop
        with phase_clock(times, "12 model axis"):
            model_axis_phase(torch, ops, add)
        with phase_clock(times, "13 train mesh"):
            train_mesh_phase(torch, ops)
        with phase_clock(times, "14 train mesh families"):
            train_mesh_families_phase(torch, ops)
        with phase_clock(times, "15 mesh dry-run"):
            mesh_dryrun_phase(torch, ops, add)
        with phase_clock(times, "16 family serve mesh"):
            family_serve_phase(torch, ops, add)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"phase times (s): {json.dumps(times)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
