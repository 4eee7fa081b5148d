#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU, and
check it: the L2S screened decode of the paper's LSTM (nmt-deen-lstm), the
training side (the LM trainer and Algorithm 1, fitting a screen; training
zamba2-2.7b and mamba2-1.3b through the SSD kernel's backward), the
Mamba2/Zamba2 decode path (zamba2-2.7b), continuous batching (decode
streams, the scheduler and the serving launcher) on both, the other heads
(adaptive on the fused kernel, the §4.1 baselines on the host),
speculative decoding and the page pool, the dense transformers
(gemma-2b, starcoder2-3b, qwen1.5-110b) with paged attention decode, the
moe transformers (mixtral-8x7b with its sliding-window ring cache,
phi3.5-moe over the page store), the vlm (qwen2-vl-2b with M-RoPE over
256 patch embeddings, through the model API) and audio (hubert-xlarge's
bidirectional encoder) families, and training the dense, moe, vlm and
audio families.

    python3 chip_smoke.py
    python3 chip_smoke.py --only sharded   # build, train and l2s, [sharded]
    python3 chip_smoke.py --only cost      # build, train and l2s, [cost]
    python3 chip_smoke.py --only mesh      # build, [mesh]
    python3 chip_smoke.py --only train-ssm # [train-ssm], its result as JSON
    python3 chip_smoke.py --only fused-batch  # build, [fused-batch], its rows

Phases, one line (or a few) each:

  1. device   the card's name, and its name and power limit as nvidia-smi
              reports them;
  2. build    every kernel compiled from ``src/repro_torch/csrc`` (one nvcc
              per source, in parallel) and loaded;
  3. parity   each kernel against its plain PyTorch version on the card, at
              the main path's shapes (nmt-deen-lstm: d = 500, V = 25,000 →
              196 blocks, r = 100 clusters, K = 16 blocks per cluster, some
              clusters sentinel-padded; B ∈ {1, 8}, k ∈ {1, 5}), plus a
              dense-tie fixture and an all-sentinel row; the route also at
              zamba2-2.7b's d = 2560 (B ∈ {1, 4, 130}) and on an exact tie
              between clusters held by different blocks of its thread
              block cluster (the first index must win). Routes and ids
              must be equal except where the plain scores differ by less
              than 1e-5 relative (counted and printed); values and logZ
              agree within rtol = atol = 1e-5; the fused and unfused paths
              are bit-identical on ids and values. Then the fused kernel's
              split design (blocks per row, slot and part of the tile,
              merged by each row's last block) over k in {1, 5, 128, 129,
              130} x K in {1, 3, 16, 200} x B in {1, 4, 130} and k = K*128
              at K = 3, with sentinels mid-row and an all-sentinel row:
              fused == unfused bit for bit at d = 500 and 2560; a tie
              across blocks (slots and parts) going to the lowest
              position; noise; two calls bit-identical in ids, vals and
              logZ. Then the gather kernel's split grid (a block per row,
              slot and part of the tile) at d in {30, 130, 500, 2560} x
              B in {1, 4, 8, 20} with ids random, repeated in a row,
              shared across rows, all on one cluster, sentinels mixed with
              tile 0 plus an all-sentinel row, and a beam of 4 x 5 rows,
              and the full cover: against
              its plain version (rtol = atol = 1e-5), bit for bit against
              the fused kernel's masked logits (k = K*128), the same bits
              at P = 1, 2, 4, 8, two calls bit-identical. Then the bf16
              bodies of the route, gather and fused kernels (bf16 head and
              h, float32 v) against their plain versions at d = 500, 2560
              and mamba2-1.3b's 2048 (V = 50,280: 393 tiles, the last
              padded), B in 1, 4, 8 (rtol = atol = 1e-5; fused == unfused
              bit for bit), and the fused kernel at the shapes its merge once
              refused (K = 225 and 250 tiles, k = 115, 128, 129; float32
              and bf16) on 0.5-grid weights: ids and values == plain ==
              unfused bit for bit;
  4. timing   CUDA-event median times of each kernel, its plain version
              and, where one PyTorch call computes the same function, that
              call, timed in turns (library, kernel, plain, plain, kernel,
              library), L2 flushed before each call by reading 256 MB (so
              it holds clean lines, as a decode step finds it); beside
              each, its bound (bytes over 3.35 TB/s or float32 flops over
              67 TFLOP/s, the larger; the gather kernels' bytes count each
              distinct tile once); the L2S kernels at d = 500 and at
              zamba2's d = 2560; the fused kernel also beside the unfused
              composition (screened_logits + torch.where + stable top-k +
              logsumexp, "unfused_ms"); both gather kernels at B = 4,
              K = 16, k = 1 once more under each flush in turns (reading,
              zeroing, the earlier flush, zeroing, reading); each tile cut
              into P = 1, 2, 4 and 8 parts for the fused kernel there, and
              for screened_logits at every shape it is timed (P = 1 is its
              grid before the split) and at a beam's shape (B = 20 rows in
              4 groups of 5, one cluster each, K = 16, d = 500 and 2560,
              timed with its bound); the three L2S kernels' bf16 bodies at
              d = 2560 (bound at 2 bytes a weight), and the bf16 fused
              kernel over all 250 of zamba2's tiles at k = 128;
     fused-batch  the fused kernel at the benchmark's translation batch, on
              a head, screen and 640 contexts drawn from a fixed seed at
              the lstm-batch-screened cell's widths (d = 500, V = 25,000,
              r = 100, K = 9): the routes' clusters by rows; group_rows
              against its plain version (chunks equal, each tile's pairs
              as sets); the grouped grid == the per-row grid (ids, vals,
              logZ) and == the unfused path (ids, vals) bit for bit, and
              == the plain version (vals and logZ within TOL, ids but at
              near-ties), float32 and bfloat16 (496 of the 500 values),
              k = 1, 5, 128, every row on one cluster, each on its own,
              B = 637 with sentinel slots, P = 2 and 8, noise; then both
              grids, the grouping alone and the whole head call (route,
              ids, kernel) on each grid at B in CROSS_B, in turns, beside
              the bound: the crossover that sets GROUPED_MIN_ROWS
              (``--only fused-batch`` prints the rows as JSON last);
  5. e2e      full-width nmt-deen-lstm (random weights from a seeded
              torch.Generator) on DecodeEngine(device="cuda"), whose decode
              steps are CUDA graph replays: greedy
              4 prompts × 16 tokens through exact and screened-cuda (fused
              and unfused), sampled decode (Gumbel-max and top-p), beam
              search (beam 5), and a full-cover screen whose screened-cuda
              tokens must equal the exact head's except after a step whose
              exact top-2 gap is below 1e-4. Launch counters are reset just
              before and read just after: every kernel must have launched;
              a profile of the fused greedy decode; the unfused greedy and
              top-p decodes, counted from zero, must launch screened_logits
              once a step (profiled for its device time);
     graph    on a fresh engine over the same model: greedy 4 x 16, sampled
              (T = 1 on each head, top-p 0.9 on screened-cuda) and beam 5
              through exact and screened-cuda fused and unfused (the latter
              registered as "screened-cuda-unfused"), first with the step
              bodies run eagerly (repro_torch.testing), then through the
              engine's graphs: tokens and beams bit-identical, launch
              counts (each side from zero) equal, sampled tokens equal to
              the head's own sample(h, generator=...) draws, one graph per
              (head, kind); prints compiled_step_counts, the launches per replay,
              the memory the graph pools add, and graph against eager
              host-clock tokens/s, median decode step and profiled idle
              share with the port's kernels' device time per launch;
     serve    16 ServeRequests (greedy and sampled, k = 1 and 5, prompts of
              8 and 12 tokens) routed by a CostAwarePolicy over exact and
              screened-cuda fused and unfused, one with an explicit head,
              through DecodeEngine.serve_batch: greedy results equal solo
              generate calls, and a second identical serve_batch adds no
              graph;
     train    the training side on full-width nmt-deen-lstm (seeded random
              init): the synthetic Zipf-Markov corpus (V = 25,000, 64
              successors; its host build time printed); one train step on
              the card against the same step on the CPU (gradients within
              1e-4 of the largest |g|, loss and gnorm within rtol 1e-5);
              300 steps of 32 x 64 tokens (lr 2e-3, warmup 20, cosine):
              the mean loss of the last 20 steps below the first 20's,
              every gnorm finite; s/step and peak device memory;
     l2s      Algorithm 1 on the trained LM: 100,000 contexts with their
              exact top-5 (90,000 to fit, 10,000 held out), fit_l2s (r =
              100, budget 1,024 words, 128-word blocks, 4 rounds x 200
              v-steps of 512) and the k-means-only ablation on the card,
              each round's loss, Lbar, coverage and c-/v-step times; the
              route kernel's clusters give back the fit's coverage (rows
              whose top-2 cluster scores differ by < 1e-5 relative aside);
              on the held-out rows screened-cuda fused == unfused ids, ==
              the plain block screened head (sentinels mapped) except rows
              whose top-k gap is < 1e-5; P@1 / P@5 against exact for L2S
              and k-means only, Lbar and the analytic speedup; greedy 4 x 16
              through exact and screened-cuda on DecodeEngine with the
              fitted screen (token agreement); launches of the evaluation
              and decode, counted from zero, with route and fused top-k
              launched; exact against screened-cuda head times (CUDA
              events) at B = 1 and B = 10,000;
     stream   on the trained LM and fitted screen: one screened-cuda
              DecodeStream of width 8, 12 requests (prompts of 8 and 12
              tokens, 4 to 24 new) joining at ticks 0, 0, 1, 3, 3, 5, ...:
              tokens equal solo generate except after a step whose top-2
              gap (route or candidate logits) is below 1e-4 (counted); a
              re-run bit-identical and adding no graph (one per (head,
              kind) at width 8); a width-1 sampled stream equal to solo
              sampled generate bit for bit;
     sched    on the same engine: ContinuousScheduler(max_slots=8,
              max_streams=4, LogicalClock) over 48 requests, 2 a tick,
              tiers round-robin (TierPolicy realtime -> screened-cuda,
              standard -> screened-cuda-unfused, else exact), a quarter
              sampled (T = 0.9, top-p 0.95), BudgetAdmission at 4x the
              catalog's largest flops_per_query: greedy results equal solo
              generate under the gap rule, a second identical run adds no
              graph and gives the same results bit for bit, the three L2S
              kernels launched (from zero), a profiled run (device calls ==
              counted launches; idle share); then 2 transient step faults on
              screened-cuda retried (retries == 2) bit-identical to the
              fault-free drain, and a permanent fault tripping the breaker
              and falling back to exact; prints the ServerStats funnel,
              p50 / p95 (logical clock) and host-clock tok/s;
     heads    on the trained LM and fitted screen: the adaptive head from
              the training tokens' unigram counts (shortlist 2048, 4 tails:
              16 short tiles, tails of 5,738 words in 45 tiles, 196 tiles),
              fused == unfused ids and values bit for bit on the 10,000
              held-out rows, P@1 / P@5 against exact, its descent rate
              beside the cost model's p_descend, and shortlist = L == exact
              except rows whose exact top-k gap is below 1e-5 (counted); the
              §4.1 baselines (svd, shortlist, greedy-mips, lsh-mips,
              pca-mips) and screened-cpu at the reference's defaults on
              1,000 held-out rows on the host: P@1 / P@5, flops_per_query,
              host ms a query, and full-rank svd == exact under the same
              rule on 200 of them; DecodeEngine through adaptive (graphs):
              greedy 4 x 16 == its eager body and == the unfused head,
              two fused top-k launches a token (from zero, held to the
              profiler's device calls), sampled == the head's own draws,
              beam 5 == eager; the host heads svd (full rank, == exact)
              and screened-cpu (== screened-cuda) between graph replays,
              and a greedy-mips stream of width 4 with 4 joins (== solo
              generate), tokens under the gap rule; a second identical
              run adds no graph; one step's head (next(h), B = 4) of
              exact, screened-cuda and adaptive timed in turns with its
              bound;
     sharded  (run after the training phases, with the trained LM kept
              from [l2s]; its (a) and (b) run last, with [cost] between
              them) the vocab-sharded heads, every shard on the one card:
              (a)
              on the trained LM, fitted screen and counts, at 1, 2 and 8
              shards, fresh engines (graphs): greedy 4 x 16 and beam 5 of
              exact-sharded, screened-sharded (local="cuda": the fused
              kernel once per shard) and adaptive-sharded == exact,
              screened-cuda (gap rule) and adaptive (bit for bit); sampled
              T = 1 (exact-sharded == exact from one seed, the others in
              the vocabulary, the screened one in the candidate union); a
              greedy SpecDecodeStream with an exact-sharded verify == exact;
              one graph per (head, kind), none added by a second run; n
              and 1 + n fused launches a token; a profiled replay; (b) head
              calls at gemma-2b's vocabulary (V = 256,000, d = 2,048,
              float32, B = 4, a random block screen r = 100, K = 16) over 8
              shards: ids == exact's (but near-ties), screened-cuda's and
              adaptive's, log-probs within 1e-5; each shard's fused launch
              against its plain version, also on a 1,500-word slice (two
              shards all sentinel, k = 300 clipped to a shard's 256
              slots); each head's next(h), eager and as a graph replay,
              beside its unsharded twin's and its bound, and one shard's
              launch beside its plain version and bound (CUDA events,
              median of 30, clean L2); paths
              "nmt-deen-lstm sharded", "gemma-2b-vocab sharded";
     cost     (after [sharded] (a), before its (b); on the same trained LM and
              fitted screen)
              the op-level cost counter (launch/op_cost.py):
              audit_cost_drift over the 13 heads the package registers on
              the card (no error entry), each torch head's op FLOPs and
              bytes == its count on the CPU; at 4 held-out rows the fused
              screened-cuda call records no (B, K*128) float32 result and
              the unfused one does, fused bytes below unfused, both == the
              CPU's counts (the path's launches: the audit's and these
              calls'); then, counted apart, the route, gather and fused
              launches against their plain versions; the recording hooks'
              host time a wrapper call outside a count; then a dry-run
              record that fits the card (gemma-2b decode, 4 rows over 4,096
              slots, counted on meta): param bytes == the params drawn on
              the card, FLOPs and bytes == the same step counted on the
              card, the step's peak new storage run for real after a
              warm-up == the counted temp_bytes + the largest workspace
              one op holds inside its call (measured op by op), within 3 %
              of temp_bytes; paths
              "nmt-deen-lstm cost", "gemma-2b cost";
     spec     on the trained LM and fitted screen: a SpecDecodeStream of
              width 8 (draft screened-cuda, verify exact, draft_len 4) over
              [stream]'s 12 joins: greedy tokens == a plain width-8 exact
              stream under the gap rule; a second stream of the same shape
              adds no graph and repeats bit for bit; [e2e]'s random screen
              as the draft (drafted - accepted > 0); a sampled stream (T =
              1) twice from one seed, bit-identical; screened-cuda's
              dist_logits == its plain version (rtol = atol = 1e-5), its
              finite support == the routed candidate words < V, sampled ids
              inside it; a profiled round (device calls == counted
              launches); acceptance, emitted tokens per round, host time
              per round;
     pool     a width-8 PagedDecodeStream (page 16) over 16 requests on 2
              shared prompts of 48 tokens == a plain width-8 stream bit for
              bit, radix hits and prefill tokens skipped; a
              ContinuousScheduler drain on a 13-page pool (PoolExhausted,
              preemption, every request ends with a result, completed ones
              bit-identical); a drain with kv_pool= and spec=SpecPolicy()
              == the same drain without them (gap rule), its ServerStats
              pool and spec fields;
     serve-cli python -m repro_torch.launch.serve --arch nmt-deen-lstm --l2s
              --scheduler --log-jsonl ... --train-steps 50 --requests 12 on
              the card returns 0 and every JSONL record parses, and so does
              --scheduler --draft-head screened-cuda (a block screen, spec
              lanes, the page pool); bad flags (--draft-head exact among
              them) return 2;
  6. ssm      the SSD intra-chunk kernel against its plain version at
              zamba2-2.7b's prefill chunk (B = 4, nc = 2, Q = 256, H = 80,
              P = N = 64, G = 1), mamba2-1.3b's (H = 64, N = 128) and a
              short odd one (Q = 7, G = 2): max |kernel - plain| / max |plain|
              of y and of S, each <= 1e-5; the KV-cache slot update against
              its plain version, bit for bit, float32 and bfloat16, slots
              0, 127, S/2, S-1, S+5 and per-row slots, for one cache and
              for the K and V pair written in one launch; both kernels
              timed like phase 4 (the pair launch beside two single
              launches and beside cache[rows, slot] = upd done twice);
  7. hybrid f32  full-width zamba2-2.7b drawn in float32 (2.3 B parameters
              from a seeded CUDA generator) for the phases below that keep
              it ([graph], [stream], [spec], adaptive): the hidden states of
              prefill over 512 tokens and 4 decode steps equal one prefill
              over 516 (max relative error <= 1e-3); its prefill of 4 x 512
              and decode step on the host clock, for [hybrid];
     graph    the graph phase on that model on a fresh engine (greedy 4 x
              512 + 16 and beam 4, no sampling), 54 SSD launches a prefill
              and 9 cache launches a decode step;
     hybrid   zamba2-2.7b in its config's bfloat16 (4.63 GB drawn on the
              card from the same seed) on DecodeEngine(device="cuda",
              max_len=640, cache_dtype=bfloat16): greedy 4 prompts x 512
              tokens (2 SSD chunks), 32 new, through exact, the plain
              screened head and screened-cuda (fused and unfused; r = 100,
              K = 16 over 250 blocks): fused == unfused tokens,
              screened-cuda == plain screened under the bf16 gap rule
              (GAP_BF16 on the plain head's bf16 logits and cluster scores
              along its own path); beam search (beam 4); a full-cover
              screen whose tokens equal exact's under the same rule (on the
              exact head's bf16 logits); one prompt of 4,096 tokens (the
              chunked attention path; max_len 4,160, 32 new) whose
              screened-cuda tokens == the plain screened head's under the
              rule. Counters are reset just before and read just after:
              ssd_intra 54 launches a prefill, the cache update 9 (once per
              shared-attention application) a decode step, the bf16 L2S
              bodies launched and the float32 ones not. Then a self-check
              (prefill 512 + 4 decode steps against one prefill of 516, <=
              0.1 relative), a profile of one greedy screened-cuda decode
              (with the fused kernel's share of device time), and on the
              host clock the bf16 decode step and prefill tokens/s beside
              float32's and the cost of _sdpa's float32 copies of the K/V
              caches (CUDA events); then each kernel's launch cost at its
              decode shape: one eager launch, a one-launch graph and a
              graph of 9 launches, in turns under the timer;
     ssm bf16 full-width mamba2-1.3b in its config's bfloat16: greedy 4 x
              512 + 32 through exact, the plain screened head and
              screened-cuda fused and unfused (fused == unfused tokens, ==
              plain under the bf16 gap rule), 48 SSD launches a prefill (its
              chunk shape), no cache launch, only the bf16 L2S bodies; the
              bf16 decode step and prefill on the host clock;
     stream   on the float32 zamba2-2.7b: one screened-cuda stream of width 4,
              prompts of 512, 384, 256 and 100 tokens joining at ticks 0, 3,
              7 and 12 (per-row positions), 32 new each: ssd_intra 54 times
              a join, the K/V cache pair 9 times a step; tokens equal solo
              generate under the gap rule; one transient fault after every
              row joined gives the fault-free tokens and cache (K/V, SSM
              states, conv tails) bit for bit; the time of the step's
              rollback snapshot and of a join's splice;
     spec     on the same zamba2-2.7b: a SpecDecodeStream of width 4
              (draft screened-cuda on the random screen, verify exact,
              draft_len 4), 4 prompts of 512, 32 new: tokens == a plain
              width-4 exact stream under the gap rule, drafted - accepted >
              0 (the SSM states restored from the snapshot ring, K/V left
              unrestored); the ring's bytes and one slot's copy time;
     heads    adaptive on the same zamba2-2.7b (tiers by weight-row norm,
              shortlist 2048, 4 tails): greedy 4 x 512 + 32 through graphs,
              fused == unfused tokens, launches counted from zero (two
              fused top-k a token, 54 SSD, 9 cache a step) and held to the
              profiler; shortlist = L == exact under the gap rule; the head
              steps timed at d = 2560 as at d = 500;
     Every profile (e2e, hybrid, graph) holds the device calls the
              profiler counts for each port kernel equal to the launches
              its wrapper counted in the same call (graph replays add
              the count their capture recorded).
  7b. dense  (after the launch costs, before training) the dense family
              in its configs' bfloat16, drawn on the card: [parity] and
              [timing] at its new shapes (the route at gemma-2b's d = 2048
              and qwen1.5-110b's d = 8192, 4 rows of h a thread block
              cluster there, with a tie across the cluster's blocks; the
              bf16 gather and fused kernels over gemma's 2,000 tiles, k in
              1, 5, 128; gather and fused at d = 8192; the cache pair at
              (KV, hd) = (1, 256), (5, 64), (2, 128)); full-width gemma-2b
              (18 layers, d = 2048, MQA hd 256, GeGLU, V = 256,000, tied):
              greedy 4 x 512 + 32 through exact, the plain `screened` head
              and screened-cuda fused and unfused, beam 4, sampled (== the
              head's own draws), a full cover; screened-cuda held to the
              plain head and the full cover to exact under the bf16 gap
              rule; graphs == eager step bodies; a profile (device calls ==
              counted launches, idle share), step time, prefill tokens/s,
              the exact head's device time against screened-cuda's and the
              step's weight-read bound; [dense] paged: a width-4
              PagedDecodeStream (pages of 16) == a plain stream bit for bit,
              radix hits, a drain on a small pool (PoolExhausted,
              preemption); [dense] spec: a width-4 SpecDecodeStream with a
              screened-cuda draft, tokens == a plain exact stream under the
              gap rule, rejections, no snapshot ring; starcoder2-3b at full
              width (layernorm, gelu, qkv bias, kv 2 hd 128) and
              qwen1.5-110b at full widths cut to 2 layers (d = 8192, the
              route kernel there): greedy 4 x 128 + 16 through exact and
              screened-cuda, held to the plain head; the serving
              launcher on reduced gemma-2b on the card (--scheduler, a
              screened-cuda head and draft, a page pool); paths
              "gemma-2b bf16",
              "gemma-2b paged", "gemma-2b spec", "starcoder2-3b bf16",
              "qwen1.5-110b bf16";
  7c. moe    (after the dense phases) [parity] and [timing] at the moe
              shapes: the route (bf16 h) at d = 4096 with a tie across the
              cluster's blocks; the bf16 gather and fused kernels over
              mixtral-8x7b's 250 tiles and phi3.5-moe's 251 (the last tile
              64 real words, in every row), k in 1, 5, 128, fused ==
              unfused bit for bit, no padded word in a top-k; the cache
              pair at mixtral's ring (4, 4096, 8, 128) bf16 at wrapped
              per-row slots, bit for bit; timing rows at mixtral's width,
              over phi's tiles and at the ring's shape. Then mixtral-8x7b
              at full widths cut to 8 of 32 layers in bf16 (11.9 B
              parameters; 32 do not fit one card): greedy 4 x 512 + 32
              through exact, the plain screened head, screened-cuda fused
              and unfused, beam 4, sampled, a full cover, graphs == eager
              bodies, profiles, the step's weight-read bound (every expert
              is read each step); a ring run (2 prompts of 4,000 tokens,
              240 new: the 4,096-slot ring wraps by 144) held to the plain
              head under the bf16 gap rule; a width-4 SpecDecodeStream on
              prompts of 4,080 whose drafts cross the wrap (rows restored
              from a snapshot ring that holds the ring K/V caches whole),
              == a plain exact stream under the gap rule; a float32 copy at
              2 layers with no slot dropped: prefill 4,000 + 240 ring
              decode steps == one windowed forward within 1e-4 of max |h|;
              phi3.5-moe at full widths cut to 2 layers (layernorm, 16
              experts, 251 tiles): greedy 4 x 128 + 16 and a width-4
              paged stream == a plain stream bit for bit; paths
              "mixtral-8x7b bf16", "mixtral-8x7b ring", "mixtral-8x7b
              spec", "phi3.5-moe bf16", "phi3.5-moe paged";
  7d. vlm, audio  (after the moe phases) [parity] and [timing] at
              qwen2-vl-2b's shapes: the route (bf16 h) at d = 1536, B in
              1, 4, with a tie across the cluster's blocks; the bf16 gather
              and fused kernels over its 1,187 tiles, k in 1, 5, 128 (fused
              == unfused bit for bit); the cache pair at its cache (4, 544,
              2, 128) bf16, bit for bit; timing rows at its width and
              cache. [vlm] qwen2-vl-2b at full width in bf16 (28 layers,
              d = 1536, kv 2, qkv bias, M-RoPE, V = 151,936, vision_proj;
              3.09 GB) through Model.prefill / decode_step (the engine
              refuses the family, as the reference's has no patch path):
              4 x (256 patches + 256 tokens) + 32 greedy tokens through
              exact, screened-cuda fused and unfused (r = 100, K = 16) and
              a full cover: fused == unfused tokens, full cover == exact
              under the bf16 gap rule, launches from zero (28 cache pairs a
              step, only the bf16 L2S bodies), profiles, prefill
              positions/s, the eager step on the host clock and in device
              time, the heads' times and bounds, the step's weight-read
              bound; [vlm] card vs CPU: 2 layers in float32, prefill with
              patches + 8 decode steps, hidden states within 1e-4, tokens
              equal but near ties; [audio] hubert-xlarge at full width,
              bf16 weights and float32 frames (float32 activations, as the
              reference promotes them): 4 x 1,024 frames (frames/s, peak
              memory, no port kernel), 2,048 frames chunked == unchunked
              within 1e-5 relative, 2 layers card == CPU within 1e-4;
              paths "qwen2-vl-2b bf16", "hubert-xlarge";
  8. train-ssm (after the serving phases and their profiles, in a process
              of its own: python3 chip_smoke.py --only train-ssm) the SSD
              backward kernel against ssd_intra_bwd_plain at zamba2's and
              mamba2's chunks: max |kernel - plain| / max
              |plain| of dxw, dB, dC and dl, each <= 1e-4, two launches bit
              for bit; both timed like phase 4, with the bound of the
              gradient's five causal products and two Q x N x P ones, both
              on the FMA units and in the kernel's split TF32 (3 x flops
              at the TF32 peak), the latter the kernels line's bound_ms;
              the HMMA count of the kernel's SASS (cuobjdump) and its
              ptxas report (registers, spills);
              zamba2-2.7b at full width cut to 6 layers (one shared-block
              application), one batch of 1 x 512: loss_and_grads on the
              card (the kernels) against the CPU (the plain versions),
              every leaf within 1e-4 x max |g|, the loss within 1e-5
              relative; full-width zamba2-2.7b in float32 on 4 x 512: the
              gradients of remat none and block bit for bit (their times
              and peak memory), a profiled remat-block forward and backward
              (device calls == counted launches; ssd_intra_bwd's share of
              its device time), then 3 steps of
              make_train_step (remat block, donated) on that batch: the
              loss falls at every step, peak device memory under 80 GiB,
              ssd_intra 3 L (each layer run, and rerun by its super-block's
              and its own recompute) and ssd_intra_bwd L launches a step;
              mamba2-1.3b at full width, 2 steps (3 L - 1 forward launches
              a step: its one super-block's recompute stops before its last
              layer); paths "zamba2-2.7b train" and "mamba2-1.3b train";
     serve-cli zamba2  on full-width zamba2-2.7b (float32, drawn on the
              host as the launchers draw): python -m
              repro_torch.launch.train --steps 2 --batch 4 --seq 512
              --ckpt-dir <tmp> (a 27.8 GB checkpoint of params and AdamW
              state) and the same again, which resumes from it with nothing
              left to train or save; python -m repro_torch.launch.serve
              --l2s --head screened-cuda --budget 1024 --train-steps 2
              --requests 4 --max-new 8 returns 0 with its token-agreement
              line;
     train-dense python -m repro_torch.launch.train --arch gemma-2b
              --steps 2 --batch 4 --seq 512 at full width in float32 (the
              256,000-word corpus built on the host in <= 60 s, s/step,
              peak device memory); gemma-2b cut to 2 layers, card against
              CPU gradients at 1 x 256 (within 1e-4 x max |g|, loss 1e-5);
     train-moe mixtral-8x7b at full widths cut to 2 layers in float32:
              make_train_step(donate=True), 2 steps of 4 x 512 (the aux
              loss finite and in the loss, the loss falling, peak memory);
              1 layer, card against CPU gradients at 1 x 128;
     train-vlm, train-audio  python -m repro_torch.launch.train --arch
              qwen2-vl-2b (then hubert-xlarge) --steps 2 --batch 4 --seq
              512 at full width in float32 (4 x (256 patches + 512
              tokens), the 151,936-word corpus built on the host; 4 x 512
              frames): s/step, peak device memory under 80 GiB; 2 layers,
              card against CPU gradients; paths "gemma-2b train",
              "mixtral-8x7b train", "qwen2-vl-2b train", "hubert-xlarge
              train" (no port kernel runs there: 0 launches);
  8b. mesh   (last, after [sharded] (b)) the sharded dry run on this
              machine's torch: gemma-2b decode_32k through the l2s head and
              mamba2-1.3b prefill_32k (through ssd_intra) counted at full
              width and depth on the 16x16 counting mesh (a fake process
              group, meta tensors; launch/dryrun.py::lower_combo): one
              device's argument and temp bytes, FLOPs, bytes, collective
              bytes by kind, bound and seconds; no error record, and the
              argument bytes == the sum of every argument's shard bytes
              under its sharding's spec; then nmt-deen-lstm's (float32)
              and gemma-2b's (bf16, 18 layers) l2s decode steps at full
              width on the card, B = 4 over a random 64-slot cache, once
              as they are and once with params, screen, cache and inputs
              DTensors on a (1, 1) mesh over the card: the route and fused
              kernels (and gemma's cache pair) launch through local_map as
              often as without a mesh, the ids bit for bit; paths
              "nmt-deen-lstm mesh (1, 1)", "gemma-2b mesh (1, 1)";
  9. a JSON line {"kernels": [...]} (each kernel with its launches on the
              path it was ported for and, in "launches_by_path", on each
              path: the two e2e paths, their graph phases, serve, the
              fitted screen's "nmt-deen-lstm l2s-fit", the streams
              ("nmt-deen-lstm stream", "zamba2-2.7b stream"),
              "nmt-deen-lstm scheduler", "nmt-deen-lstm heads",
              "nmt-deen-lstm sharded", "gemma-2b-vocab sharded",
              "nmt-deen-lstm cost", "gemma-2b cost", the two [mesh] paths,
              "zamba2-2.7b adaptive", "nmt-deen-lstm spec", "nmt-deen-lstm
              paged", "zamba2-2.7b spec", "mamba2-1.3b bf16", the five
              dense paths, the five moe paths, "qwen2-vl-2b bf16",
              "hubert-xlarge", "zamba2-2.7b train", "mamba2-1.3b train",
              "gemma-2b train", "mixtral-8x7b train", "qwen2-vl-2b train"
              and "hubert-xlarge train" (the
              "zamba2-2.7b" path is its bfloat16 model), each
              counted from zero over that path's own runs; the bf16 bodies
              as kernels of their own, "cluster_route_bf16",
              "screened_logits_bf16" and "fused_screened_topk_bf16", timed
              at d = 2560, the last with "full_cover_k128"; its
              "launch_cost_ms" eager, in a graph and per launch in a graph
              of 9;
              the three L2S kernels also "at_zamba2_width"; the gather
              kernel "at_beam_shape"; the fused kernel "unfused_ms" and
              "adaptive_step" (the [heads] step times and bounds),
              "at_gemma_vocab_shard" (one shard's launch of [sharded] (b)),
              "sharded_heads" (its head calls) and "at_translation_batch"
              ([fused-batch]'s rows by B); the
              cache update's times are the K and V pair's, with "single_ms"
              of one single-cache launch; the SSD backward's, at zamba2's
              chunk, with "at_mamba2_chunk"; the bf16 L2S bodies also
              "at_gemma_width", "at_mixtral_width" and
              "at_qwen2vl_width", the bf16 gather and fused
              "at_phi_tiles", the bf16 route "at_qwen_width", the cache
              pair "at_gemma_cache", "at_mixtral_ring" and
              "at_qwen2vl_cache")
              and, last, {"ok": true, "device": ...}.

Any failed check raises, and the script exits non-zero. Without a CUDA GPU,
or without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as F32_FLOP_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOP_PER_S  # noqa: E402
D, V, R, K = 500, 25_000, 100, 16
V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4
L2S_KERNELS = ("cluster_route", "screened_logits", "fused_screened_topk")
# SSD chunk shapes (B, nc, Q, H, P, G, N): zamba2-2.7b's prefill of 4 x 512
# tokens, mamba2-1.3b's, and a short odd chunk
SSD_SHAPES = {"zamba2": (4, 2, 256, 80, 64, 1, 64),
              "mamba2": (4, 2, 256, 64, 64, 1, 128),
              "short": (4, 1, 7, 80, 64, 2, 64)}
SSD_REL_TOL = 1e-5
# zamba2-2.7b's decode cache: B = 4 rows of max_len = 640 slots, 32 KV heads
# of 80 channels; hybrid decode 4 prompts x 512 tokens, 32 new
CACHE_SHAPE = (4, 640, 32, 80)
ZB, ZT, ZNEW, ZMAX = 4, 512, 32, 640
# new tokens of the float32 zamba2 [graph] phase, whose eager step bodies
# (its reference side) take ~70 ms a step on the host
ZGRAPH_NEW = 16
ZD, ZV = 2560, 32_000                # zamba2-2.7b's d_model and vocabulary
MD, MV = 2048, 50_280                # mamba2-1.3b's: 393 tiles, the last padded
# zamba2-2.7b in its config's bfloat16: one prompt of 4,096 tokens (the
# chunked attention path; 16 SSD chunks a layer), 32 new, 4,160 slots
ZLONG, ZLONG_MAX = 4096, 4160
# the gap rule's margin in bfloat16: two bf16 ulps of a logit in [4, 8)
# (the plain heads round each logit to bf16; the kernels keep float32)
GAP_BF16 = 0.0625
BF16_KERNELS = tuple(k + "_bf16" for k in L2S_KERNELS)
# the shapes the fused kernel's merge once refused: K tiles x k
FAULT1 = [(K_, k) for K_ in (225, 250) for k in (115, 128, 129)]
# [fused-batch]'s head at the lstm-batch-screened cell's widths (rows,
# clusters, blocks a cluster), its seed, and the batch widths of the fused
# kernel's two grids' crossover
BATCH_B, BATCH_R, BATCH_K = 640, 100, 9
BATCH_SEED = 2_611_390_417
CROSS_B = (4, 20, 64, 96, 128, 192, 256, 640)


def log(*a):
    print(*a, flush=True)


WALLS = {}                       # phase → host-clock seconds, for [done]


def walled(name, fn, *args):
    """``fn(*args)``, its wall kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    WALLS[name] = round(time.perf_counter() - t0, 1)
    return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- fixtures ------------------------------------------------------------------
def make_head(torch, seed, kind="normal", vocab=V, d=D):
    """(W (vocab, d), b (vocab,)) on the card: random normal or quantized
    (ties)."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((vocab, d), generator=g)
    if kind == "ties":
        return (torch.round(W * 2) / 2).cuda(), torch.zeros(vocab).cuda()
    return (W * 0.05).cuda(), (torch.randn((vocab,), generator=g) * 0.1).cuda()


def make_screen_blocks(np, seed, n_blk, r=R, k=K, dups=False):
    """(r, K) int32 candidate blocks: K distinct sorted blocks per cluster,
    every 7th cluster with only 10 real blocks and 6 sentinel slots (with
    ``dups``, blocks may repeat: ties across slots)."""
    rng = np.random.default_rng(seed)
    cand = np.full((r, k), n_blk, np.int32)
    for t in range(r):
        n = 10 if t % 7 == 3 else k
        cand[t, :n] = (rng.integers(0, n_blk, n) if dups else
                       np.sort(rng.choice(n_blk, n, replace=False)))
    return cand


# -- timing --------------------------------------------------------------------
class Timer:
    """Median device time of one call, L2 flushed before each: the stream
    is held by a short sleep while the host enqueues the call, so host
    overhead does not enter the measurement.

    The flush reads a 256 MB buffer (a sum into a preallocated scalar), so
    the timed call finds L2 full of clean lines, as a decode step finds it
    after the step before. ``dirty=True`` flushes by zeroing the buffer
    instead (the earlier timer): the call then also pays for writing
    up to 50 MB of dirty lines back to device memory."""

    def __init__(self, torch, reps=30, dirty=False):
        self.torch = torch
        self.reps = reps
        self.dirty = dirty
        self.flush = torch.zeros(256 * 2 ** 20 // 4, device="cuda")
        self.total = torch.zeros((), device="cuda")
        self.n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def _flush(self):
        if self.dirty:
            self.flush.zero_()
        else:
            self.torch.sum(self.flush, dim=0, out=self.total)

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self._flush()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def turns(self, fns):
        """{name: fn} → {name: mean of two medians}, timed in turns: each
        in the given order, then each in the reverse order (library,
        kernel, plain, plain, kernel, library)."""
        got = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            got[name].append(self(fns[name]))
        return {name: sum(t) / len(t) for name, t in got.items()}


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# each port kernel's device symbols, as the profiler names them
KERNEL_NAMES = {"cluster_route": ("route_kernel",),
                "screened_logits": ("screened_logits_kernel",),
                "fused_screened_topk": ("fused_topk_kernel",),
                "ssd_intra": ("ssd_intra_kernel",),
                "ssd_intra_bwd": ("ssd_intra_bwd_kernel",),
                "cache_slot_update": ("cache_kv_update_kernel",
                                      "cache_slot_update_kernel"),
                "cluster_route_bf16": ("route_bf16_kernel",),
                "screened_logits_bf16": ("screened_logits_bf16_kernel",),
                "fused_screened_topk_bf16": ("fused_topk_bf16_kernel",),
                "group_rows": ("group_rows_kernel",)}


def kernel_events(kern, name):
    """The profiler's events of the port kernel ``name``."""
    return [e for e in kern if any(sym in e.key for sym in KERNEL_NAMES[name])]


def profile_counted(torch, tag, fn):
    """Profile one call of ``fn`` → its device kernels' events. The call
    count the profiler gives each port kernel must equal the launches its
    wrapper counted in the same call (a graph replay adds the count its
    capture recorded): the counts the launch checks read are the device's.
    A profiler that sees no kernel fails this too. The profiler's trace of
    a long, host-bound call can lose kernel records (seen once in the
    scheduler's drain of 25,000 kernels: every kernel short by a quarter);
    when it saw fewer calls of every port kernel than were counted, the
    call is profiled once more, its counts undone first, and that second
    profile must agree."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        counted = {k: ops.LAUNCHES[k] - before[k] for k in KERNEL_NAMES}
        seen = {k: sum(e.count for e in kernel_events(kern, k))
                for k in KERNEL_NAMES}
        if (attempt == 2 or seen == counted or
                any(seen[k] > counted[k] for k in KERNEL_NAMES)):
            break
        log(f"{tag} profile: the trace holds fewer device calls {seen} than "
            f"the wrappers counted {counted} (records lost); profiling the "
            f"call once more")
        ops.LAUNCHES.update(before)
    if seen != counted:          # name every event of a port kernel's symbol
        log(f"{tag} profile: events of the port's kernels "
            + json.dumps({k: [(e.key[:80], e.count) for e in
                              kernel_events(kern, k)] for k in KERNEL_NAMES}))
    check(seen == counted, f"{tag} profile: the device ran the port's kernels "
          f"{seen} times, their wrappers counted {counted}")
    log(f"{tag} profile: device calls == counted launches {json.dumps(seen)}")
    return kern


def fused_share(kern, busy_ms, name="fused_screened_topk"):
    """The fused top-k kernel's (``name``: its body) device time in a
    profile, and its share."""
    ev = kernel_events(kern, name)
    ms = sum(e.self_device_time_total for e in ev) / 1e3
    return (f"{KERNEL_NAMES[name][0]} {ms:.3f} ms x"
            f"{sum(e.count for e in ev)} ({ms / busy_ms:.1%} of device time)")


# -- phases ----------------------------------------------------------------------
def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name}; devices visible: {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return name, smi.splitlines()[0]


def phase_build(ops):
    t0 = time.perf_counter()
    libs = ops.build_kernels()
    for stem in libs:
        ops._library(stem)
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel libraries built and loaded in "
        f"{secs:.1f} s under {ops.BUILD_DIR.relative_to(ROOT)}")
    for stem, so in libs.items():
        report = so.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        usage = [ln.split("ptxas info    : ")[-1] for ln in lines
                 if "Used" in ln or "spill" in ln]
        log(f"[build] {stem}: " + " | ".join(usage))


def phase_parity(torch, np, K_):
    """Kernels vs plain versions on the card. → {kernel: max abs err}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)

    err = {"cluster_route": 0.0, "screened_logits": 0.0,
           "fused_screened_topk": 0.0}
    near_ties = 0

    def ids_match(name, got, want, got_score, want_score):
        """Positions where ids differ must be near-ties: the scores there
        differ by less than 1e-5 relative."""
        nonlocal near_ties
        diff = (got != want).nonzero(as_tuple=True)
        if diff[0].numel():
            a, b = got_score[diff], want_score[diff]
            rel = (a - b).abs() / b.abs().clamp_min(1e-30)
            check(bool((rel < 1e-5).all()),
                  f"{name}: {diff[0].numel()} ids differ beyond near-ties")
            near_ties += diff[0].numel()

    for kind in ("normal", "ties"):
        W, b = make_head(torch, 1 if kind == "normal" else 2, kind)
        Wb, bb = ops.pack_head_blocks(W, b)
        n_blk = Wb.shape[0]
        check(n_blk == 196 and int((bb[-1] <= NEG_INF / 2).sum()) == 88,
              f"packing: {n_blk} blocks, last one padded wrong")
        cand = torch.from_numpy(make_screen_blocks(
            np, 3, n_blk, dups=kind == "ties")).cuda()
        g = torch.Generator().manual_seed(4)
        v = torch.randn((R, D), generator=g).cuda()
        for B in (1, 8):
            h = torch.randn((B, D), generator=g)
            if kind == "ties":
                h = torch.round(h) * 0.5
            h = h.cuda()
            route = cluster_route(h, v)
            plain = cluster_route_plain(h, v)
            scores = h @ v.T
            s_route = scores.gather(1, route.long()[:, None])[:, 0]
            s_plain = scores.gather(1, plain.long()[:, None])[:, 0]
            ids_match("cluster_route", route, plain, s_route, s_plain)
            err["cluster_route"] = max(err["cluster_route"],
                                       float((s_route - s_plain).abs().max()))
            block_ids = cand[plain.long()].contiguous()
            if B == 8:
                block_ids[-1] = n_blk                     # all-sentinel row
            raw = screened_logits(Wb, bb, h, block_ids)
            raw_p = screened_logits_plain(Wb, bb, h, block_ids)
            torch.testing.assert_close(raw, raw_p, **TOL)
            if kind == "ties":
                check(torch.equal(raw, raw_p), "ties: screened not exact")
            err["screened_logits"] = max(err["screened_logits"],
                                         float((raw - raw_p).abs().max()))
            valid = (block_ids < n_blk)[..., None]
            row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
            lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
            word = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                               n_blk * V_BLK).reshape(B, -1)
            for k in (1, 5, 130):
                gn = torch.Generator(device="cuda").manual_seed(k)
                for noise in (None, ops.gumbel_noise((B, K_, V_BLK), gn,
                                                     "cuda")):
                    fi, fv, fz = fused_screened_topk(Wb, bb, h, block_ids, k,
                                                     noise)
                    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h,
                                                           block_ids, k, noise)
                    torch.testing.assert_close(fv, pv, **TOL)
                    fin = torch.isfinite(pz)
                    check(torch.equal(fin, torch.isfinite(fz)),
                          "fused: logZ finiteness differs")
                    torch.testing.assert_close(fz[fin], pz[fin], **TOL)
                    ids_match("fused_screened_topk", fi, pi, fv, pv)
                    err["fused_screened_topk"] = max(
                        err["fused_screened_topk"],
                        float((fv - pv).abs().max()),
                        float((fz[fin] - pz[fin]).abs().max()))
                    if kind == "ties":
                        check(torch.equal(fv, pv) and torch.equal(fi, pi),
                              "ties: fused not exact")
                    if noise is None:
                        # fused == masked unfused kernel logits + stable
                        # top-k, bit for bit
                        uv, upos = topk_desc(row, k)
                        check(torch.equal(fv, uv) and
                              torch.equal(fi, torch.gather(word, 1, upos)),
                              f"fused != unfused (B={B}, k={k}, {kind})")
                    if B == 8:
                        check(bool((fi[-1] == n_blk * V_BLK).all()) and
                              bool((fv[-1] == NEG_INF).all()) and
                              bool(torch.isneginf(fz[-1])),
                              "all-sentinel row: wrong ids, vals or logZ")
            # the compositions, routing through the kernel
            for k in (1, 5):
                ui, uv = ops.screened_topk(Wb, bb, v, cand, h, k=k)
                fi, fv, _ = ops.screened_fused_topk(Wb, bb, v, cand, h, k=k)
                check(torch.equal(ui, fi) and torch.equal(uv, fv),
                      f"screened_fused_topk != screened_topk (B={B}, k={k})")
    # the route at zamba2-2.7b's width, B up to 130 (17 thread block
    # clusters), and an exact tie across the blocks of one cluster: t = 3
    # in block 0, t = 50 and t = 99 in later blocks; the first index wins
    g = torch.Generator().manual_seed(9)
    vz = torch.randn((R, ZD), generator=g).cuda()
    for B in (1, 4, 130):
        h = torch.randn((B, ZD), generator=g).cuda()
        route, plain = cluster_route(h, vz), cluster_route_plain(h, vz)
        scores = h @ vz.T
        s_route = scores.gather(1, route.long()[:, None])[:, 0]
        s_plain = scores.gather(1, plain.long()[:, None])[:, 0]
        ids_match("cluster_route d=2560", route, plain, s_route, s_plain)
        err["cluster_route"] = max(err["cluster_route"],
                                   float((s_route - s_plain).abs().max()))
    vt = torch.round(torch.randn((R, D), generator=g) * 2) / 2
    vt[3] = vt[50] = vt[99] = 4.0
    ht = (torch.round(torch.rand((8, D), generator=g) * 3) * 0.5 + 0.5).cuda()
    check(bool((cluster_route_plain(ht, vt.cuda()) == 3).all()) and
          bool((cluster_route(ht, vt.cuda()) == 3).all()),
          "cluster_route: a tie across blocks did not pick the first index")
    log(f"[parity] kernels match their plain versions (rtol=atol=1e-5), "
        f"fused == unfused bit for bit, ties exact (route also at d={ZD}, "
        f"B in 1, 4, 130, and tied across the blocks of a cluster); near-tie "
        f"id positions: {near_ties}; max abs err {json.dumps(err)}")
    return err


def phase_fused_split(torch, np):
    """The fused kernel's split design on the card: parity over the k, K, B
    grid, fused == unfused bit for bit at d = 500 and 2560, a tie across
    blocks, mid-row sentinels, an all-sentinel row, noise, and run-to-run
    determinism. → max abs err against the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import (fused_parts,
                                                fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import screened_logits
    err = 0.0
    near = 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def one(Wb, bb, h, ids, k, noise=None):
        """One call against the plain version, and (without noise) against
        the masked unfused kernel logits + stable top-k, bit for bit."""
        nonlocal err, near
        n_blk = Wb.shape[0]
        B = h.shape[0]
        fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k, noise)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k, noise)
        torch.testing.assert_close(fv, pv, **TOL)
        fin = torch.isfinite(pz)
        check(torch.equal(fin, torch.isfinite(fz)) and
              bool(torch.isneginf(fz[~fin]).all()), "fused split: logZ not "
              "finite where the plain one is, or not -inf elsewhere")
        torch.testing.assert_close(fz[fin], pz[fin], **TOL)
        diff = fi != pi
        if bool(diff.any()):
            rel = (fv[diff] - pv[diff]).abs() / pv[diff].abs().clamp_min(1e-30)
            check(bool((rel < 1e-5).all()), "fused split: ids differ beyond "
                  "near-ties")
            near += int(diff.sum())
        err = max(err, float((fv - pv).abs().max()),
                  float((fz[fin] - pz[fin]).abs().max()) if bool(fin.any())
                  else 0.0)
        if noise is None:
            raw = screened_logits(Wb, bb, h, ids)
            valid = ((ids >= 0) & (ids < n_blk))[..., None]
            row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
            lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
            word = torch.where(valid, ids[..., None] * V_BLK + lane,
                               n_blk * V_BLK).reshape(B, -1)
            uv, upos = topk_desc(row, k)
            check(torch.equal(fv, uv) and
                  torch.equal(fi, torch.gather(word, 1, upos)),
                  f"fused split != unfused (B={B}, K={ids.shape[1]}, k={k}, "
                  f"d={h.shape[1]})")
        return fi, fv, fz

    def sentinels(ids, n_blk):
        K = ids.shape[1]
        ids[:, K // 2] = n_blk                    # mid-row sentinels
        if K > 2:
            ids[::2, 1] = -1
        if ids.shape[0] > 1:
            ids[-1] = n_blk                       # an all-sentinel row
        return ids

    W, b = make_head(torch, 21)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    g = torch.Generator().manual_seed(22)
    grid = [(B, K_, k) for B in (1, 4, 130) for K_ in (1, 3, 16, 200)
            for k in (1, 5, 128, 129, 130) if k <= K_ * V_BLK]
    grid += [(B, 3, 3 * V_BLK) for B in (1, 4, 130)]
    parts = set()
    for B, K_, k in grid:
        h = torch.randn((B, D), generator=g).cuda()
        ids = torch.randint(0, n_blk, (B, K_), generator=g,
                            dtype=torch.int32).cuda()
        fi, fv, fz = one(Wb, bb, h, sentinels(ids, n_blk), k)
        parts.add(fused_parts(B, K_, n_sm))
        if B > 1:
            check(bool((fi[-1] == n_blk * V_BLK).all()) and
                  bool((fv[-1] == NEG_INF).all()) and
                  bool(torch.isneginf(fz[-1])),
                  f"all-sentinel row (B={B}, K={K_}, k={k}): wrong ids, vals "
                  f"or logZ")
    # noise, and two calls bit-identical in ids, vals and logZ
    for B, k in ((4, 1), (4, 5), (130, 130)):
        h = torch.randn((B, D), generator=g).cuda()
        ids = sentinels(torch.randint(0, n_blk, (B, K), generator=g,
                                      dtype=torch.int32).cuda(), n_blk)
        gn = torch.Generator(device="cuda").manual_seed(B + k)
        noise = ops.gumbel_noise((B, K, V_BLK), gn, "cuda")
        for nz in (None, noise):
            a = one(Wb, bb, h, ids, k, nz)
            b_ = fused_screened_topk(Wb, bb, h, ids, k, nz)
            check(all(torch.equal(x, y) for x, y in zip(a, b_)),
                  f"fused split: two calls differ (B={B}, k={k})")
    # a tie across blocks: equal maxima at slot 2 row 120, slot 5 row 64 and
    # slot 9 row 3 (three parts, three slots); W = 0, so logits are biases
    Wt = torch.zeros((40 * V_BLK, 32), device="cuda")
    bt = torch.rand((40 * V_BLK,), generator=g).cuda()
    Wtb, btb = ops.pack_head_blocks(Wt, bt)
    tie_ids = torch.randperm(40, generator=g)[:K].to(torch.int32)
    tied = [(2, 120), (5, 64), (9, 3)]
    for j, lane in tied:
        btb[int(tie_ids[j]), lane] = 5.0
    want = [int(tie_ids[j]) * V_BLK + lane for j, lane in tied]
    for B in (1, 4):
        h = torch.randn((B, 32), generator=g).cuda()
        ids = tie_ids.repeat(B, 1).contiguous().cuda()
        for k in (1, 3):
            fi, fv, _ = one(Wtb, btb, h, ids, k)
            check(fi.tolist() == [want[:k]] * B and bool((fv == 5.0).all()),
                  f"fused split: tie across blocks gave {fi.tolist()}, "
                  f"want {want[:k]}")
    del W, b, Wb, bb
    # fused == unfused at zamba2-2.7b's width
    W, b = make_head(torch, 23, vocab=ZV, d=ZD)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    for B, k in ((1, 1), (4, 1), (4, 5), (130, 130)):
        h = torch.randn((B, ZD), generator=g).cuda()
        ids = sentinels(torch.randint(0, n_blk, (B, K), generator=g,
                                      dtype=torch.int32).cuda(), n_blk)
        one(Wb, bb, h, ids, k)
    torch.cuda.synchronize()
    from repro_torch.kernels import fused_topk
    check(all(int(c.abs().sum()) == 0 for c in fused_topk._COUNTERS.values()),
          "fused split: a merge counter was left non-zero")
    log(f"[parity] fused split (parts per tile {sorted(parts)}): {len(grid)} "
        f"(B, K, k) cases at d={D} with mid-row and all-sentinel rows, "
        f"fused == unfused bit for bit at d={D} and d={ZD}, tie across slots "
        f"and parts -> lowest position, noise, two calls bit-identical in "
        f"ids, vals and logZ, counters left zero; near-tie id positions vs "
        f"plain: {near}; max abs err {err:.3g}")
    return err


def phase_screen_grid(torch, np):
    """The gather kernel's split grid on the card: each case against the
    plain version (rtol = atol = 1e-5) and bit for bit against the fused
    kernel's masked logits (k = K*128, so every logit is compared), the
    same bits at P = 1, 2, 4, 8 parts per tile, and two calls
    bit-identical. → max abs err against the plain version."""
    from repro_torch.kernels import ops, screen
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    from repro_torch.testing import screen_id_patterns
    err, cases = 0.0, 0
    g = torch.Generator().manual_seed(40)

    def one(label, Wb, bb, h, ids):
        nonlocal err, cases
        n_blk = Wb.shape[0]
        B, K_ = ids.shape
        got = screened_logits(Wb, bb, h, ids)
        want = screened_logits_plain(Wb, bb, h, ids)
        torch.testing.assert_close(got, want, **TOL)
        check(torch.equal(got, screened_logits(Wb, bb, h, ids)),
              f"screened_logits {label}: two calls differ")
        for p in (1, 2, 4, 8):
            check(torch.equal(got, screen._launch(Wb, bb, h, ids, p)),
                  f"screened_logits {label}: P={p} gives other bits")
        valid = ((ids >= 0) & (ids < n_blk))[..., None]
        row = torch.where(valid, got, NEG_INF).reshape(B, -1)
        lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
        word = torch.where(valid, ids[..., None] * V_BLK + lane,
                           n_blk * V_BLK).reshape(B, -1)
        fi, fv, _ = fused_screened_topk(Wb, bb, h, ids, K_ * V_BLK)
        uv, upos = topk_desc(row, K_ * V_BLK)
        check(torch.equal(fv, uv) and torch.equal(fi, torch.gather(word, 1,
                                                                   upos)),
              f"screened_logits {label}: masked logits != the fused kernel's")
        err = max(err, float((got - want).abs().max()))
        cases += 1

    for d, vocab in ((30, 3000), (130, 3000), (D, V), (ZD, ZV)):
        W, b = make_head(torch, 41 + d, vocab=vocab, d=d)
        Wb, bb = ops.pack_head_blocks(W, b)
        n_blk = Wb.shape[0]
        for B in (1, 4, 8, 20):
            h = torch.randn((B, d), generator=g).cuda()
            for name, ids in screen_id_patterns(g, n_blk, B, K).items():
                one(f"d={d} B={B} {name}", Wb, bb, h, ids.cuda())
        if d == D:                                 # full cover, K = 200
            full = torch.full((4, 200), n_blk, dtype=torch.int32)
            full[:, :n_blk] = torch.arange(n_blk, dtype=torch.int32)
            one("full cover", Wb, bb, torch.randn((4, d), generator=g).cuda(),
                full.cuda())
        del W, b, Wb, bb
    log(f"[parity] screened_logits split grid: {cases} cases (d in "
        f"30, 130, {D}, {ZD}; B in 1, 4, 8, 20; ids random, repeated in a "
        f"row, shared across rows, one cluster, sentinels with tile 0 and an "
        f"all-sentinel row, a beam of 4 x 5 rows; full cover K = 200): == "
        f"plain (rtol=atol=1e-5), == the fused kernel's masked logits bit for "
        f"bit, the same bits at P = 1, 2, 4, 8, two calls bit-identical; max "
        f"abs err {err:.3g}")
    return err


def phase_parity_bf16(torch, np):
    """The bfloat16 bodies of the route, gather and fused kernels against
    their plain versions on the card (bf16 head and h, float32 v), at
    the shapes of the three paths that run them: d = 500 (V = 25,000),
    zamba2-2.7b's d = 2560 (V = 32,000) and mamba2-1.3b's d = 2048
    (V = 50,280: 393 tiles, the last padded), B in 1, 4, 8, K = 16, k in
    1, 5, 130: routes equal except near-ties (plain
    scores within 1e-5 relative), logits, values and logZ within
    rtol = atol = 1e-5, fused == unfused bit for bit; then the fused
    kernel at the shapes its merge once refused (K = 225 and 250 tiles,
    k = 115, 128, 129; B = 1 and 4; float32 and bf16, d = 2560) on weights
    and h of a 0.5 grid, where every sum is exact: ids and values equal the
    plain version's bit for bit, and the unfused path's. → {bf16 kernel:
    max abs err}."""
    from repro_torch.kernels import fused_topk, ops
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.ref import NEG_INF
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    err = {k: 0.0 for k in BF16_KERNELS}
    near = 0
    for d, vocab in ((D, V), (ZD, ZV), (MD, MV)):
        W, b = make_head(torch, 70 + d, vocab=vocab, d=d)
        Wb, bb = ops.pack_head_blocks(W.bfloat16(), b.bfloat16())
        del W, b
        n_blk = Wb.shape[0]
        g = torch.Generator().manual_seed(71 + d)
        v = torch.randn((R, d), generator=g).cuda()
        cand = torch.from_numpy(make_screen_blocks(np, 72 + d, n_blk)).cuda()
        for B in (1, 4, 8):
            h = torch.randn((B, d), generator=g).cuda().bfloat16()
            route, plain = cluster_route(h, v), cluster_route_plain(h, v)
            scores = h.float() @ v.T
            s_r = scores.gather(1, route.long()[:, None])[:, 0]
            s_p = scores.gather(1, plain.long()[:, None])[:, 0]
            diff = route != plain
            check(bool(((s_r - s_p).abs()[diff] <
                        1e-5 * s_p.abs()[diff]).all()),
                  f"cluster_route bf16 d={d} B={B}: routes differ beyond "
                  f"near-ties")
            near += int(diff.sum())
            err["cluster_route_bf16"] = max(err["cluster_route_bf16"],
                                            float((s_r - s_p).abs().max()))
            ids = cand[plain.long()].contiguous()
            if B == 8:
                ids[-1] = n_blk                        # an all-sentinel row
            raw = screened_logits(Wb, bb, h, ids)
            torch.testing.assert_close(raw, screened_logits_plain(
                Wb, bb, h, ids), **TOL)
            err["screened_logits_bf16"] = max(
                err["screened_logits_bf16"], float((raw - screened_logits_plain(
                    Wb, bb, h, ids)).abs().max()))
            for k in (1, 5, 130):
                fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k)
                pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
                torch.testing.assert_close(fv, pv, **TOL)
                fin = torch.isfinite(pz)
                check(torch.equal(fin, torch.isfinite(fz)),
                      "fused bf16: logZ finiteness differs")
                torch.testing.assert_close(fz[fin], pz[fin], **TOL)
                err["fused_screened_topk_bf16"] = max(
                    err["fused_screened_topk_bf16"],
                    float((fv - pv).abs().max()))
                ui, uv, _ = unfused_topk(Wb, bb, h, ids, k)
                check(torch.equal(fi, ui) and torch.equal(fv, uv),
                      f"fused bf16 != unfused bf16 (d={d}, B={B}, k={k})")
        del Wb, bb
    # the shapes the merge once refused, bit for bit on exact sums
    g = torch.Generator().manual_seed(80)
    W = (torch.round(torch.randn((ZV, ZD), generator=g) * 2) / 2).cuda()
    h4 = (torch.round(torch.randn((4, ZD), generator=g)) * 0.5).cuda()
    n_blk = -(-ZV // V_BLK)
    served = []
    for dtype in (torch.float32, torch.bfloat16):
        Wb, bb = ops.pack_head_blocks(W.to(dtype),
                                      torch.zeros(ZV, device="cuda",
                                                  dtype=dtype))
        for K_, k in FAULT1:
            ids = torch.stack([torch.randperm(n_blk, generator=g)[:K_]
                               for _ in range(4)]).to(torch.int32).cuda()
            ids[:, K_ // 2] = n_blk                   # mid-row sentinels
            ids[-1] = n_blk                           # an all-sentinel row
            for B in (1, 4):
                h, ib = h4[:B].to(dtype).contiguous(), ids[:B].contiguous()
                fi, fv, fz = fused_screened_topk(Wb, bb, h, ib, k)
                pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ib, k)
                ui, uv, _ = unfused_topk(Wb, bb, h, ib, k)
                check(torch.equal(fi, pi) and torch.equal(fv, pv) and
                      torch.equal(fi, ui) and torch.equal(fv, uv),
                      f"fused at K={K_} k={k} B={B} {dtype}: not bit for bit "
                      f"the plain and unfused ids and values")
                fin = torch.isfinite(pz)
                check(torch.equal(fin, torch.isfinite(fz)),
                      "fused at the refused shapes: logZ finiteness differs")
                torch.testing.assert_close(fz[fin], pz[fin], **TOL)
                if B == 4:
                    check(bool((fv[-1] == NEG_INF).all()),
                          "fused at the refused shapes: all-sentinel row")
            P = fused_topk.fused_parts(4, K_, torch.cuda.get_device_properties(
                0).multi_processor_count)
            served.append(f"K={K_} k={k} P={P}")
        del Wb, bb
    torch.cuda.synchronize()
    check(all(int(c.abs().sum()) == 0 for c in fused_topk._COUNTERS.values()),
          "fused: a merge counter was left non-zero")
    log(f"[parity] bf16 route, gather and fused kernels == their plain "
        f"versions at d={D}, {ZD} and {MD} (V={V}, {ZV}, {MV}), B in 1, 4, "
        f"8, k in 1, 5, 130 (rtol=atol=1e-5; route "
        f"near-ties {near}), fused == unfused bit for bit; max abs err "
        f"{json.dumps(err)}")
    log(f"[parity] fused at the shapes the merge once refused, float32 and "
        f"bf16, B = 1 and 4, d={ZD}, 0.5-grid weights: ids and values == "
        f"plain == unfused bit for bit ({'; '.join(served[:len(FAULT1)])})")
    return err


def unfused_topk(Wb, bb, h, block_ids, k):
    """The unfused composition the fused kernel replaces: the gather kernel,
    the sentinel mask, a stable top-k and a logsumexp."""
    import torch
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import screened_logits
    n_blk = Wb.shape[0]
    B = h.shape[0]
    raw = screened_logits(Wb, bb, h, block_ids)
    valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
    logz = torch.logsumexp(torch.where(valid, raw, -torch.inf).reshape(B, -1),
                           dim=-1)
    vals, pos = topk_desc(torch.where(valid, raw, NEG_INF).reshape(B, -1), k)
    lane = torch.arange(V_BLK, dtype=torch.int32, device=h.device)
    word = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    return torch.gather(word, 1, pos), vals, logz


def l2s_rows(torch, np, timer, Wb, bb, v, screen, B, k, seed):
    """Timing rows of the three L2S kernels at one decode shape: each
    kernel in turns with its plain version (and, for the route, the one
    PyTorch call), and its bound at these inputs."""
    from repro_torch.kernels import fused_topk
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    n_blk, _, d = Wb.shape
    r, Ks = v.shape[0], screen.shape[1]
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((B, d), generator=g).cuda().to(Wb.dtype)
    block_ids = screen[cluster_route_plain(h, v).long()].contiguous()
    valid = block_ids < n_blk
    safe_u = int(torch.unique(torch.where(valid, block_ids, 0)).numel())
    valid_u = int(torch.unique(block_ids[valid]).numel())
    n_valid = int(valid.sum())
    esz = Wb.element_size()                    # 4 (float32) or 2 (bf16)
    tile_bytes = V_BLK * (d + 1) * esz
    t = timer.turns({"library_ms": lambda: torch.argmax(h.float() @ v.T,
                                                        dim=-1),
                     "ms": lambda: cluster_route(h, v),
                     "plain_ms": lambda: cluster_route_plain(h, v)})
    rows = {"cluster_route": dict(
        t, bound=bound_ms(esz * B * d + 4 * (r * d + B), 2 * B * r * d))}
    t = timer.turns({"ms": lambda: screened_logits(Wb, bb, h, block_ids),
                     "plain_ms": lambda: screened_logits_plain(Wb, bb, h,
                                                               block_ids)})
    rows["screened_logits"] = dict(
        t, library_ms=None,
        bound=bound_ms(safe_u * tile_bytes + esz * B * d + 4 * B * Ks +
                       4 * B * Ks * V_BLK, 2 * B * Ks * V_BLK * d))
    t = timer.turns({"ms": lambda: fused_screened_topk(Wb, bb, h, block_ids,
                                                       k),
                     "plain_ms": lambda: fused_screened_topk_plain(
                         Wb, bb, h, block_ids, k),
                     "unfused_ms": lambda: unfused_topk(Wb, bb, h, block_ids,
                                                        k)})
    rows["fused_screened_topk"] = dict(
        t, library_ms=None,
        bound=bound_ms(valid_u * tile_bytes + esz * B * d + 4 * B * Ks +
                       4 * (2 * B * k + B), 2 * n_valid * V_BLK * d))
    if (B, k, Ks) == (4, 1, K) and esz == 4:
        # the wrapper picks P parts per tile; time each P in turns
        sweep = timer.turns({f"P={p}": (lambda p=p: fused_topk._launch(
            Wb, bb, h, block_ids, k, None, p)) for p in (1, 2, 4, 8)})
        log(f"[timing] d={d} B={B} K={Ks} k={k} fused_screened_topk by parts "
            f"per tile (the wrapper picks P="
            f"{fused_topk.fused_parts(B, Ks, timer.n_sm)}): " +
            ", ".join(f"{n} {x:.5f} ms" for n, x in sweep.items()))
        flush_compare(timer, f"d={d} B={B} K={Ks} k={k}", {
            "screened_logits": lambda: screened_logits(Wb, bb, h, block_ids),
            "fused_screened_topk": lambda: fused_screened_topk(
                Wb, bb, h, block_ids, k)})
    screen_sweep(timer, Wb, bb, h, block_ids, f"d={d} B={B} K={Ks}")
    if esz == 2:
        rows = {name + "_bf16": row for name, row in rows.items()}
    for name, row in rows.items():
        lib = row["library_ms"]
        extra = (f", unfused {row['unfused_ms']:.5f} ms (ratio "
                 f"{row['unfused_ms'] / row['ms']:.2f})"
                 if "unfused_ms" in row else "")
        log(f"[timing] {Wb.dtype} d={d} B={B} K={Ks} k={k} {name}: "
            f"{row['ms']:.5f} ms, "
            f"plain {row['plain_ms']:.5f} ms, library "
            f"{'null' if lib is None else f'{lib:.5f}'} ms{extra}, bound "
            f"{row['bound'][0]:.7f} ms ({row['bound'][1]}); distinct tiles "
            f"{valid_u}")
    return rows


def flush_compare(timer, label, fns):
    """Each of ``fns`` timed once under each L2 flush, in turns (reading,
    zeroing, zeroing, reading): how much of a time was the zeroing flush's
    write-back of dirty lines."""
    got = {(name, dirty): [] for name in fns for dirty in (False, True)}
    for dirty in (False, True, True, False):
        timer.dirty = dirty
        for name, fn in fns.items():
            got[(name, dirty)].append(timer(fn))
    timer.dirty = False
    log(f"[timing] {label} L2 flush by reading (clean lines) / by zeroing "
        f"(dirty lines, the earlier timer): " + "; ".join(
            f"{name} {sum(got[(name, False)]) / 2:.5f} / "
            f"{sum(got[(name, True)]) / 2:.5f} ms" for name in fns))


def screen_sweep(timer, Wb, bb, h, ids, label):
    """screened_logits with each tile cut into P = 1, 2, 4, 8 parts, in
    turns, beside the P the wrapper's rule picks."""
    from repro_torch.kernels import screen
    B, Ks = ids.shape
    sweep = timer.turns({f"P={p}": (lambda p=p: screen._launch(
        Wb, bb, h, ids, p)) for p in (1, 2, 4, 8)})
    rule = screen.screen_parts(B, Ks, Wb.shape[2], timer.n_sm,
                               Wb.element_size())
    log(f"[timing] {label} {Wb.dtype} screened_logits by parts per tile "
        f"(the wrapper "
        f"picks P={rule}; P=1 is the grid before the split): " +
        ", ".join(f"{n} {x:.5f} ms" for n, x in sweep.items()))


def beam_rows(torch, timer, Wb, bb, screen, seed):
    """The gather kernels at a beam's shape: B = 20 rows in 4 groups of 5,
    each group routed to one cluster (the hypotheses of a beam mostly share
    one), K = 16; bound by the distinct tiles. → screened_logits' timing
    dict."""
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    n_blk, _, d = Wb.shape
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((20, d), generator=g).cuda()
    clusters = torch.randperm(screen.shape[0], generator=g)[:4]
    ids = screen[clusters.repeat_interleave(5).cuda()].contiguous()
    B, Ks = ids.shape
    distinct = int(torch.unique(torch.where(ids < n_blk, ids, 0)).numel())
    t = timer.turns({"ms": lambda: screened_logits(Wb, bb, h, ids),
                     "plain_ms": lambda: screened_logits_plain(Wb, bb, h,
                                                               ids),
                     "fused_ms": lambda: fused_screened_topk(Wb, bb, h, ids,
                                                             5)})
    t.update(library_ms=None, bound=bound_ms(
        distinct * V_BLK * (d + 1) * 4 + 4 * (B * d + B * Ks) +
        4 * B * Ks * V_BLK, 2 * B * Ks * V_BLK * d))
    log(f"[timing] d={d} beam B={B} (4 groups of 5 rows, one cluster each) "
        f"K={Ks} screened_logits: {t['ms']:.5f} ms, plain "
        f"{t['plain_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
        f"({t['bound'][1]}; distinct tiles {distinct} of {B * Ks}); "
        f"fused_screened_topk k=5 {t['fused_ms']:.5f} ms")
    screen_sweep(timer, Wb, bb, h, ids, f"d={d} beam B={B} K={Ks}")
    return t


def phase_timing(torch, np):
    """→ ({kernel: timing dict} at the LSTM greedy decode step's shape
    (d = 500, B = 4, K = 16, k = 1), {kernel: timing dict} of the three L2S
    kernels at zamba2-2.7b's width (d = 2560, same B, K, k), in float32 and
    (keys ending "_bf16") in bfloat16, the bf16 fused kernel's also at the
    full cover with k = 128, [the gather kernel's timing dict at the beam
    shape, d = 500 and 2560]), after a table over B ∈ {1, 4, 8} and the
    full-cover screen's K = 200.
    CUDA-event medians with L2 flushed (clean) before each call, each kernel
    in turns with its plain version and the library call."""
    from repro_torch.kernels import ops
    timer = Timer(torch)
    W, b = make_head(torch, 1)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    cand = torch.from_numpy(make_screen_blocks(np, 3, n_blk)).cuda()
    v = torch.randn((R, D), generator=torch.Generator().manual_seed(5)).cuda()
    full = torch.full((R, -(-n_blk // 8) * 8), n_blk, dtype=torch.int32,
                      device="cuda")
    full[:, :n_blk] = torch.arange(n_blk, device="cuda", dtype=torch.int32)
    out = {}
    for i, (B, k, screen) in enumerate(((1, 5, cand), (4, 1, cand),
                                        (8, 5, cand), (4, 1, full))):
        rows = l2s_rows(torch, np, timer, Wb, bb, v, screen, B, k, 50 + i)
        if (B, k, screen.shape[1]) == (4, 1, K):
            out = rows
    beam = [beam_rows(torch, timer, Wb, bb, cand, 55)]
    del W, b, Wb, bb
    W, b = make_head(torch, 11, vocab=ZV, d=ZD)
    Wb, bb = ops.pack_head_blocks(W, b)
    cand = torch.from_numpy(make_screen_blocks(np, 12, Wb.shape[0])).cuda()
    vz = torch.randn((R, ZD), generator=torch.Generator().manual_seed(13))
    wide = l2s_rows(torch, np, timer, Wb, bb, vz.cuda(), cand, 4, 1, 60)
    beam.append(beam_rows(torch, timer, Wb, bb, cand, 65))
    # the same head in bfloat16, as zamba2-2.7b serves it (rows 1c, 2f, 3c)
    Wb, bb = Wb.bfloat16(), bb.bfloat16()
    wide.update(l2s_rows(torch, np, timer, Wb, bb, vz.cuda(), cand, 4, 1, 60))
    wide["fused_screened_topk_bf16"]["full_cover_k128"] = fault1_row(
        torch, timer, Wb, bb)
    return out, wide, beam


def fault1_row(torch, timer, Wb, bb, B=4, k=128):
    """Row 3d: the fused kernel at zamba2-2.7b's full cover (all 250 tiles
    in every row) and k = 128, a shape its merge once refused, in turns
    with its plain version and the unfused composition; the bound counts
    each of the 250 tiles once."""
    from repro_torch.kernels import fused_topk
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    n_blk, _, d = Wb.shape
    h = torch.randn((B, d), generator=torch.Generator().manual_seed(66))
    h = h.cuda().to(Wb.dtype)
    ids = torch.arange(n_blk, dtype=torch.int32,
                       device="cuda").repeat(B, 1).contiguous()
    t = timer.turns({"ms": lambda: fused_screened_topk(Wb, bb, h, ids, k),
                     "plain_ms": lambda: fused_screened_topk_plain(
                         Wb, bb, h, ids, k),
                     "unfused_ms": lambda: unfused_topk(Wb, bb, h, ids, k)})
    esz = Wb.element_size()
    nbytes = (n_blk * V_BLK * (d + 1) * esz + esz * B * d + 4 * B * n_blk +
              4 * (2 * B * k + B))
    t.update(library_ms=None, bound=bound_ms(nbytes,
                                             2 * B * n_blk * V_BLK * d))
    t["parts"] = fused_topk.fused_parts(B, n_blk, timer.n_sm)
    log(f"[timing] {Wb.dtype} d={d} B={B} K={n_blk} (full cover) k={k} "
        f"fused_screened_topk: {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} "
        f"ms, unfused {t['unfused_ms']:.5f} ms, bound {t['bound'][0]:.5f} ms "
        f"({t['bound'][1]}); P={t['parts']}")
    return t


def batch_head(torch, seed):
    """A head, screen and contexts at the benchmark's translation batch,
    drawn from ``seed`` at the lstm-batch-screened cell's widths (d = 500,
    V = 25,000, r = 100 random centroids, K = 9 distinct random 128-word
    blocks a cluster, 640 rows of h): the packed head, v, cand and h on the
    card."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_blk = -(-V // V_BLK)
    W = torch.randn((V, D), generator=g, device="cuda") * 0.05
    b = torch.randn((V,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W, b)
    v = torch.randn((BATCH_R, D), generator=g, device="cuda") / math.sqrt(D)
    order = torch.rand((BATCH_R, n_blk), generator=g, device="cuda").argsort(1)
    cand = order[:, :BATCH_K].sort(1).values.to(torch.int32).contiguous()
    h = torch.tanh(torch.randn((BATCH_B, D), generator=g, device="cuda"))
    return Wb, bb, v, cand, h.contiguous()


def grids_agree(torch, tag, Wb, bb, h, cluster, ids, k, cand, noise=None,
                parts=None):
    """The grouped grid against the per-row grid at the same P: ids, vals
    and logZ bit for bit; against the plain version
    (``fused_screened_topk_plain``): ids equal but at near-ties (values
    within 1e-5 relative), vals and logZ within TOL, logZ −∞ where the
    plain one is; without noise, ids and vals also against the masked
    unfused kernel logits + stable top-k, bit for bit. → the ids that
    differ from the plain version's at near-ties."""
    from repro_torch.kernels import fused_topk
    from repro_torch.kernels.fused_topk import fused_screened_topk_plain
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import screened_logits
    n_blk = Wb.shape[0]
    B, K_ = ids.shape
    P = parts or fused_topk.fused_parts(
        B, K_, torch.cuda.get_device_properties(0).multi_processor_count)
    row = fused_topk._launch(Wb, bb, h, ids, k, noise, P)
    gi, gv, gz = fused_topk._launch_grouped(Wb, bb, h, ids, k, noise, P,
                                            cluster, cand)
    check(all(torch.equal(a, b) for a, b in zip(row, (gi, gv, gz))),
          f"[fused-batch] {tag}: the grouped grid's ids, vals or logZ differ "
          f"from the per-row grid's (B={B}, K={K_}, k={k}, P={P})")
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k, noise)
    torch.testing.assert_close(gv, pv, **TOL)
    fin = torch.isfinite(pz)
    check(torch.equal(fin, torch.isfinite(gz)) and
          bool(torch.isneginf(gz[~fin]).all()),
          f"[fused-batch] {tag}: logZ not finite where the plain one is, or "
          f"not -inf elsewhere (B={B}, k={k})")
    torch.testing.assert_close(gz[fin], pz[fin], **TOL)
    diff = gi != pi
    if bool(diff.any()):
        rel = (gv[diff] - pv[diff]).abs() / pv[diff].abs().clamp_min(1e-30)
        check(bool((rel < 1e-5).all()),
              f"[fused-batch] {tag}: grouped ids differ from the plain "
              f"version's beyond near-ties (B={B}, k={k})")
    if noise is None:
        raw = screened_logits(Wb, bb, h, ids)
        valid = ((ids >= 0) & (ids < n_blk))[..., None]
        lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
        word = torch.where(valid, ids[..., None] * V_BLK + lane,
                           n_blk * V_BLK).reshape(B, -1)
        uv, upos = topk_desc(torch.where(valid, raw, NEG_INF).reshape(B, -1),
                             k)
        check(torch.equal(gv, uv) and
              torch.equal(gi, torch.gather(word, 1, upos)),
              f"[fused-batch] {tag}: grouped != unfused (B={B}, k={k})")
    return int(diff.sum())


def phase_fused_batch(torch, np):
    """The fused kernel at a translation batch, at the benchmark cell's
    widths (``batch_head``): the routes' rows a cluster; the grouping
    kernel == its plain version; the grouped grid == the per-row grid at
    equal P (ids, vals, logZ bit for bit), == the plain version (vals and
    logZ within TOL) and == the unfused path (ids, vals) in
    float32 and bfloat16, k = 1, 5, 128, with noise, every row on one
    cluster, every row on its own, a cluster of more than G rows, B not a
    multiple of G and sentinel slots; then both grids' times and the bound
    at the cell's shape (B = 640, K = 9, d = 500, k = 1, float32) and at
    B in CROSS_B (the crossover that sets GROUPED_MIN_ROWS); and the
    grouped-launch counter after a 640-row and a 4-row head call.
    → the timing rows."""
    from repro_torch.kernels import fused_topk, ops
    from repro_torch.kernels.route import cluster_route
    G = fused_topk.GROUP_PAIRS
    Wb, bb, v, cand, h = batch_head(torch, BATCH_SEED)
    n_blk, _, d = Wb.shape
    r, Kc = cand.shape
    B = h.shape[0]
    cluster = cluster_route(h, v)
    ids = cand[cluster.long()].contiguous()
    hist = torch.bincount(cluster.long(), minlength=r).cpu()
    live = hist[hist > 0]
    sizes = torch.bincount(live)
    got = [a.cpu() for a in fused_topk.group_rows(cluster, cand, n_blk)]
    want = fused_topk.group_rows_plain(cluster.cpu(), cand.cpu(), n_blk)
    n_real = int((want[1][:, 0] > 0).sum())
    by_tile = {}                                # each tile's pairs, both sides
    for q, (m, tile) in enumerate(want[1][:n_real].tolist()):
        a, z = by_tile.setdefault(tile, ([], []))
        a += got[0][q * G:q * G + m].tolist()
        z += want[0][q * G:q * G + m].tolist()
    check(torch.equal(got[1], want[1]) and
          all(sorted(a) == sorted(z) for a, z in by_tile.values()),
          "[fused-batch] group_rows != group_rows_plain (chunks; each "
          "tile's pairs as sets)")
    log(f"[fused-batch] seed {BATCH_SEED}, the lstm-batch-screened cell's "
        f"widths: {B} rows route to {live.numel()} of {r} clusters, rows a "
        f"cluster mean {B / live.numel():.2f}, max {int(live.max())}; their "
        f"{B * Kc} (row, slot) pairs need "
        f"{int(torch.unique(ids).numel())} tiles, {n_real} chunks of up to "
        f"{G} pairs ({int((-(-live // G)).sum()) * Kc} chunks by cluster); "
        f"clusters by rows: " + json.dumps({int(n): int(c) for n, c in
                                            enumerate(sizes) if c}))

    gen = torch.Generator(device="cuda").manual_seed(7)
    noise = ops.gumbel_noise((B, Kc, V_BLK), gen, "cuda")
    odd = B - 3                                 # not a multiple of G
    one = torch.zeros(B, dtype=torch.int32, device="cuda")
    own = torch.arange(r, dtype=torch.int32, device="cuda")
    holed = cand.clone()
    holed[:, Kc // 2] = n_blk                   # sentinel slots, both kinds
    holed[::3, 1] = -1
    holed[5] = n_blk                            # an all-sentinel cluster
    mixed = torch.where(torch.arange(B, device="cuda") % 9 == 0, 5,
                        cluster).to(torch.int32)
    cases = near = 0
    for dtype in (torch.float32, torch.bfloat16):
        # bfloat16 rows of 500 values are no whole number of 16-byte
        # chunks: the grouped grid takes 496 of them
        dd = d if dtype == torch.float32 else 496
        W_ = Wb[..., :dd].contiguous().to(dtype)
        b_, h_ = bb.to(dtype), h[:, :dd].contiguous().to(dtype)
        for k in (1, 5, 128):
            near += grids_agree(torch, f"{dtype} routes", W_, b_, h_,
                                cluster, ids, k, cand)
            near += grids_agree(torch, f"{dtype} one cluster", W_, b_, h_,
                                one, cand[one.long()].contiguous(), k, cand)
            near += grids_agree(torch, f"{dtype} own clusters", W_, b_,
                                h_[:r], own, cand[own.long()].contiguous(),
                                k, cand)
            near += grids_agree(torch, f"{dtype} B={odd}, sentinels", W_, b_,
                                h_[:odd].contiguous(),
                                mixed[:odd].contiguous(),
                                holed[mixed[:odd].long()].contiguous(), k,
                                holed)
            cases += 4
        for P in (2, 8):
            near += grids_agree(torch, f"{dtype} P={P}", W_, b_, h_,
                                cluster, ids, 5, cand, parts=P)
            cases += 1
        near += grids_agree(torch, f"{dtype} noise", W_, b_, h_, cluster,
                            ids, 1, cand, noise=noise)
        cases += 1
    log(f"[parity] fused_screened_topk grouped grid == per-row grid (ids, "
        f"vals, logZ) and == unfused (ids, vals), bit for bit, and == the "
        f"plain version (vals, logZ within TOL; ids but {near} at near-ties "
        f"< 1e-5): {cases} cases")

    ops.reset_launches()
    ops.screened_fused_topk(Wb, bb, v, cand, h, k=1)
    wide = dict(ops.LAUNCHES)
    ops.reset_launches()
    ops.screened_fused_topk(Wb, bb, v, cand, h[:4].contiguous(), k=1)
    narrow = dict(ops.LAUNCHES)
    check(wide["fused_screened_topk_grouped"] == 1 == wide["group_rows"] and
          narrow["fused_screened_topk_grouped"] == 0 == narrow["group_rows"],
          f"[fused-batch] grouped launches: {wide} at B = {B}, {narrow} at 4")

    timer = Timer(torch)
    tile = V_BLK * (d + 1) * 4
    rows = {}
    for b_ in sorted(set(CROSS_B) | {B}):
        hb, cb, ib = h[:b_].contiguous(), cluster[:b_], ids[:b_]
        P = fused_topk.fused_parts(b_, Kc, timer.n_sm)
        def head(grouped, hb=hb, P=P):
            """The head call on one grid: the route, the ids, the kernel."""
            c = cluster_route(hb, v)
            i = cand[c.long()].contiguous()
            if grouped:
                return fused_topk._launch_grouped(Wb, bb, hb, i, 1, None, P, c,
                                                  cand)
            return fused_topk._launch(Wb, bb, hb, i, 1, None, P)

        t = timer.turns({
            "per_row_ms": lambda: fused_topk._launch(Wb, bb, hb, ib, 1, None,
                                                     P),
            "grouped_ms": lambda: fused_topk._launch_grouped(
                Wb, bb, hb, ib, 1, None, P, cb, cand),
            "head_per_row_ms": lambda: head(False),
            "head_grouped_ms": lambda: head(True)})
        t["group_rows_ms"] = timer(lambda: fused_topk.group_rows(cb, cand,
                                                                 n_blk))
        tiles = int(torch.unique(ib).numel())
        t["bound"] = bound_ms(tiles * tile + 4 * b_ * d + 4 * b_ * Kc +
                              4 * 3 * b_, 2 * b_ * Kc * V_BLK * d)
        chunks = int((fused_topk.group_rows(cb, cand, n_blk)[1][:, 0] > 0)
                     .sum())
        t.update(B=b_, K=Kc, d=d, k=1, P=P, tiles=tiles, chunks=chunks,
                 clusters=int(torch.unique(cb).numel()))
        rows[str(b_)] = t
        log(f"[timing] fused_screened_topk B={b_} K={Kc} d={d} k=1 P={P} "
            f"({t['clusters']} clusters, {chunks} chunks, {tiles} tiles): "
            f"per-row grid {t['per_row_ms']:.5f} ms, grouped grid "
            f"{t['grouped_ms']:.5f} ms (group_rows alone "
            f"{t['group_rows_ms']:.5f}); the head call (route, ids, kernel) "
            f"per-row {t['head_per_row_ms']:.5f} / grouped "
            f"{t['head_grouped_ms']:.5f} ms (the wrapper takes the "
            f"{'grouped' if b_ >= fused_topk.GROUPED_MIN_ROWS else 'per-row'}"
            f" grid); bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
    cross = [int(b_) for b_, t in rows.items()
             if t["head_grouped_ms"] < t["head_per_row_ms"]]
    log(f"[timing] fused_screened_topk: the grouped head call is the faster "
        f"from B = {min(cross) if cross else None} of {sorted(map(int, rows))}"
        f" (GROUPED_MIN_ROWS = {fused_topk.GROUPED_MIN_ROWS})")
    return rows


def phase_e2e(torch, np):
    from repro_torch import heads
    from repro_torch.configs import V_BLK as CFG_V_BLK, get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine

    cfg = get_config("nmt-deen-lstm")
    check(cfg.d_model == D and cfg.vocab_size == V and CFG_V_BLK == V_BLK,
          "config drifted from the smoke's shapes")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    n_blk = -(-V // V_BLK)
    v = rng.standard_normal((R, D)).astype(np.float32)
    cand = make_screen_blocks(np, 6, n_blk)
    screen = screen_from_numpy(v, cand, (cand < n_blk).sum(1), V, V_BLK)
    full_idx, full_len = candidates_to_padded(np.ones((R, n_blk), bool), V,
                                              block=V_BLK)
    full = screen_from_numpy(v, full_idx, full_len, V, V_BLK)
    prompts = rng.integers(0, V, (4, 8))
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    eng_full = DecodeEngine(model, params, screen=full, device="cuda")
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    for e in (eng, eng_full):                      # warm-up: loads, caches
        e.generate(prompts, 2, head="screened-cuda")
        e.generate(prompts, 2, head="exact")

    new = 16
    ops.reset_launches()
    exact, t_exact = host_timed(torch, lambda: eng.generate(prompts, new,
                                                            head="exact"))
    scr, t_scr = host_timed(torch, lambda: eng.generate(
        prompts, new, head="screened-cuda"))
    scr_u = eng.generate(prompts, new, head=unfused)
    samp = eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                        seed=1)
    nucl = eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                        top_p=0.9, seed=2)
    beam = eng.beam_search(prompts[0], 5, new, head="screened-cuda")
    beam_x = eng.beam_search(prompts[0], 5, new, head="exact")
    f_exact = eng_full.generate(prompts, new, head="exact")
    f_scr = eng_full.generate(prompts, new, head="screened-cuda")
    launches = dict(ops.LAUNCHES)

    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u), ("sampled", samp), ("top-p", nucl)):
        check(r.tokens.shape == (4, new) and r.tokens.min() >= 0 and
              r.tokens.max() < V, f"{name}: tokens out of range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          "screened-cuda fused and unfused greedy tokens differ")
    for r in (beam, beam_x):
        check(r.tokens.shape == (1, new) and np.isfinite(r.scores).all() and
              r.tokens.max() < V, "beam search: bad result")

    # full cover: screened == exact up to the first near-tie step per row
    seq = torch.as_tensor(np.concatenate([prompts, f_exact.tokens[:, :-1]], 1),
                          device="cuda")
    with torch.inference_mode():
        h, _ = model.forward(eng.params, {"tokens": seq})
        logits = model.logits(eng.params, h[:, prompts.shape[1] - 1:])
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    near = []
    for i in range(len(prompts)):
        bad = np.nonzero(f_scr.tokens[i] != f_exact.tokens[i])[0]
        if bad.size:
            t = int(bad[0])
            check(gaps[i, t] < GAP,
                  f"full cover: row {i} differs at step {t} with exact top-2 "
                  f"gap {gaps[i, t]:.3g} >= {GAP}")
            near.append((i, t, float(gaps[i, t])))
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    # where the device time of the same greedy screened-cuda decode goes
    kern = profile_counted(torch, "[e2e] greedy screened-cuda", lambda:
                           eng.generate(prompts, new, head="screened-cuda"))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[e2e] profile, greedy 4x{new} screened-cuda: device busy "
        f"{busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall (idle "
        f"share {1 - busy_ms / (t_scr * 1e3):.3f}); "
        f"{fused_share(kern, busy_ms)}; top kernels: " +
        "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top))
    # the gather kernel on the paths that run it, once a step: unfused
    # greedy and top-p (counted exactly; the profile gives its device time)
    ops.reset_launches()

    def unfused_and_top_p():
        eng.generate(prompts, new, head=unfused)
        eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                     top_p=0.9, seed=2)
    kern = profile_counted(torch, "[e2e] unfused + top-p", unfused_and_top_p)
    n_scr = ops.LAUNCHES["screened_logits"]
    check(n_scr == 2 * new, f"screened_logits launched {n_scr} times on the "
          f"unfused and top-p paths, expected {2 * new}")
    ev = [e for e in kern if "screened_logits_kernel" in e.key]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    log(f"[e2e] greedy unfused + top-p 4x{new} screened-cuda: screened_logits "
        f"launched {n_scr} times; profile: screened_logits_kernel "
        f"x{sum(e.count for e in ev)}, {dev_ms:.3f} ms of device time")
    tok = 4 * new
    log(f"[e2e] nmt-deen-lstm d={D} V={V} on DecodeEngine(device='cuda'): "
        f"greedy 4x{new} exact {tok / t_exact:.1f} tok/s, screened-cuda "
        f"{tok / t_scr:.1f} tok/s (host clock, information only); fused == "
        f"unfused tokens; sampled/top-p/beam(5) in range, beam score "
        f"{float(beam.scores[0]):.4f} (exact head {float(beam_x.scores[0]):.4f})")
    log(f"[e2e] full-cover screen (K={full.c_max}): screened-cuda == exact "
        f"greedy tokens; rows that diverge after a near-tie step "
        f"(row, step, gap): {near}; steps with exact gap < {GAP}: "
        f"{int((gaps < GAP).sum())} of {gaps.size}")
    log(f"[e2e] launches on the main path: "
        f"{json.dumps({k: launches[k] for k in L2S_KERNELS})}")
    return launches, dict(model=model, params=eng.params, screen=screen,
                          prompts=prompts)


def ssd_inputs(torch, shape, seed):
    """Seeded SSD inputs on the card: xw, B, C normal; l a cumulative sum of
    negative log decays, as softplus(dt)·A gives them."""
    B, nc, Q, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn((B, nc, Q, H, P), generator=g)
    Bm = torch.randn((B, nc, Q, G, N), generator=g)
    Cm = torch.randn((B, nc, Q, G, N), generator=g)
    l = -torch.cumsum(torch.rand((B, nc, Q, H), generator=g) * 0.05, dim=2)
    return [a.cuda() for a in (xw, Bm, Cm, l)]


def ssd_bound(shape):
    """(bytes, flops) the SSD intra-chunk function needs: inputs read and
    outputs written once; C·B and M·x over the causal half (s <= t) and the
    chunk state, two flops per multiply-add."""
    B, nc, Q, H, P, G, N = shape
    nbytes = 4 * (2 * B * nc * Q * H * P + 2 * B * nc * Q * G * N +
                  B * nc * Q * H + B * nc * H * N * P)
    pairs = Q * (Q + 1) // 2
    flops = B * nc * H * (2 * pairs * (N + P) + 2 * Q * N * P)
    return nbytes, flops


def phase_ssm_kernels(torch):
    """SSD and cache-update kernels vs their plain versions on the card,
    then timed. → ({kernel: max abs err}, {kernel: timing dict})."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update,
                                                  cache_slot_update_plain)
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    err = {"ssd_intra": 0.0, "cache_slot_update": 0.0}
    for i, (label, shape) in enumerate(SSD_SHAPES.items()):
        args = ssd_inputs(torch, shape, 10 + i)
        (y, S), (py, pS) = ssd_intra(*args), ssd_intra_plain(*args)
        torch.cuda.synchronize()
        rel = {}
        for name, got, want in (("y", y, py), ("S", S, pS)):
            diff = float((got - want).abs().max())
            rel[name] = diff / float(want.abs().max())
            err["ssd_intra"] = max(err["ssd_intra"], diff)
            check(rel[name] <= SSD_REL_TOL,
                  f"ssd_intra {label}: {name} relative error {rel[name]:.3g}")
        log(f"[ssm] ssd_intra {label} (B, nc, Q, H, P, G, N) = {shape}: "
            f"max |kernel - plain| / max |plain|: y {rel['y']:.3g}, S "
            f"{rel['S']:.3g} (<= {SSD_REL_TOL})")
    B, S_, KV, hd = CACHE_SHAPE
    g = torch.Generator().manual_seed(20)
    slots = (0, 127, S_ // 2, S_ - 1, S_ + 5,
             torch.tensor([0, 127, S_ + 5, -1], dtype=torch.int32).cuda())
    for dtype in (torch.float32, torch.bfloat16):
        cache = torch.randn(CACHE_SHAPE, generator=g).to("cuda", dtype)
        upd = torch.randn((B, KV, hd), generator=g).to("cuda", dtype)
        cache_v = torch.randn(CACHE_SHAPE, generator=g).to("cuda", dtype)
        upd_v = torch.randn((B, KV, hd), generator=g).to("cuda", dtype)
        for slot in slots:
            got = cache_slot_update(cache.clone(), upd, slot)
            want = cache_slot_update_plain(cache.clone(), upd, slot)
            check(torch.equal(got, want),
                  f"cache_slot_update {dtype} slot {slot}: not bit-identical")
            gk, gv = cache_kv_update(cache.clone(), upd, cache_v.clone(),
                                     upd_v, slot)
            check(torch.equal(gk, want) and
                  torch.equal(gv, cache_slot_update_plain(cache_v.clone(),
                                                          upd_v, slot)),
                  f"cache_kv_update {dtype} slot {slot}: not bit-identical")
    log(f"[ssm] cache_slot_update (B, S, KV, hd) = {CACHE_SHAPE}: bit-identical "
        f"to its plain version, float32 and bfloat16, slots 0, 127, S/2, S-1, "
        f"S+5 and per-row [0, 127, S+5, -1]; the K and V pair in one launch "
        f"(cache_kv_update) bit-identical to two plain writes at the same "
        f"slots")

    timer = Timer(torch)
    out = {}
    for label in ("zamba2", "mamba2"):
        shape = SSD_SHAPES[label]
        args = ssd_inputs(torch, shape, 30)
        t = timer.turns({"ms": lambda: ssd_intra(*args),
                         "plain_ms": lambda: ssd_intra_plain(*args)})
        t.update(library_ms=None, bound=bound_ms(*ssd_bound(shape)))
        log(f"[timing] ssd_intra {label} {shape}: {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, library null, bound {t['bound'][0]:.5f} "
            f"ms ({t['bound'][1]}; bytes {ssd_bound(shape)[0]}, flops "
            f"{ssd_bound(shape)[1]})")
        if label == "zamba2":
            out["ssd_intra"] = t
    ck, cv = (torch.randn(CACHE_SHAPE, generator=g).cuda() for _ in range(2))
    uk, uv = (torch.randn((B, KV, hd), generator=g).cuda() for _ in range(2))
    rows = torch.arange(B, device="cuda")
    slot = ZT + 5

    def library():
        ck[rows, slot] = uk
        cv[rows, slot] = uv

    def singles():
        cache_slot_update(ck, uk, slot)
        cache_slot_update(cv, uv, slot)

    def plain():
        cache_slot_update_plain(ck, uk, slot)
        cache_slot_update_plain(cv, uv, slot)

    t = timer.turns({"library_ms": library,
                     "ms": lambda: cache_kv_update(ck, uk, cv, uv, slot),
                     "two_single_ms": singles, "plain_ms": plain,
                     "single_ms": lambda: cache_slot_update(ck, uk, slot)})
    t["bound"] = bound_ms(2 * 2 * B * KV * hd * 4, 0)
    log(f"[timing] cache_kv_update (K and V) {CACHE_SHAPE} f32: {t['ms']:.5f} "
        f"ms, two single launches {t['two_single_ms']:.5f} ms, one single "
        f"launch {t['single_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
        f"library (cache[rows, slot] = upd, twice) {t['library_ms']:.5f} ms, "
        f"bound {t['bound'][0]:.7f} ms ({t['bound'][1]})")
    out["cache_slot_update"] = t
    return err, out


# -- training mamba2 and zamba2 ------------------------------------------------
SSD_BWD_REL_TOL = 1e-4           # the backward kernel against its plain version
TRAIN_SSM_B, TRAIN_SSM_T = 4, 512  # two chunks of 256: the recurrence is differentiated


def ssd_bwd_bound(shape):
    """(bytes, flops) the SSD intra-chunk gradient needs: xw, B, C, l, dy
    and dS read once, dxw, dB, dC and dl written once; five products over
    the causal half (C B^T, dy xw^T, M^T dy, (dM E)^T C, (dM E) B) and two
    Q x N x P ones (B dS, xw dS^T), two flops per multiply-add."""
    B, nc, Q, H, P, G, N = shape
    n_x, n_b = B * nc * Q * H * P, B * nc * Q * G * N
    n_l, n_s = B * nc * Q * H, B * nc * H * N * P
    nbytes = 4 * (3 * n_x + 4 * n_b + 2 * n_l + n_s)
    pairs = Q * (Q + 1) // 2
    flops = B * nc * H * (2 * pairs * (3 * N + 2 * P) + 4 * Q * N * P)
    return nbytes, flops


def split_tf32_bound_ms(nbytes, flops):
    """The SSD backward kernel's own bound: its products run on the tensor
    cores in split TF32, three TF32 products for each float32 one, so
    max(bytes / HBM, 3 x flops / the TF32 peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_count(path, opcode):
    """Instructions of ``opcode`` in the SASS of the library at ``path``
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return sum(1 for line in out.splitlines() if opcode in line)


def rel_err(got, want):
    """max |got - want| / max |want| (0 when both are 0), and the max abs
    error."""
    diff = float((got - want).abs().max())
    return diff / max(float(want.abs().max()), 1e-30), diff


def grads_close(torch, tag, got, want, tol=1e-4):
    """Every leaf of ``got`` within ``tol`` x the largest |g| of ``want``.
    → (max abs error, the largest |g|)."""
    gmax = max(float(w.abs().max()) for w in want)
    err = max(float((g.cpu() - w.cpu()).abs().max()) for g, w in zip(got, want))
    check(err <= tol * gmax, f"{tag}: max |g - g_ref| {err:.3g} > {tol} x "
          f"max |g| {gmax:.3g}")
    return err, gmax


def ssm_train_run(torch, np, tag, arch, n_steps, seed, compare_remat):
    """Full-width ``arch`` drawn in float32 on the card, trained for
    ``n_steps`` steps of ``make_train_step`` (remat="block", donated params)
    on one repeated batch of 4 x 512: the loss must fall at every step.
    With ``compare_remat``, the gradients of remat "none" and "block" on
    that batch first, bit for bit; and one remat="block" forward and
    backward profiled (device calls == counted launches).
    → (launches of the steps, counted from zero; a summary dict)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten

    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda", dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_flatten(params))
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (TRAIN_SSM_B, TRAIN_SSM_T + 1)),
                           device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    tcfg = {r: TrainConfig(lr=5e-4, warmup_steps=1, total_steps=10, remat=r,
                           loss_chunk=None) for r in ("none", "block")}
    out = {"params": n_params}
    if compare_remat:
        peak = {}
        grads = {}
        for r in ("none", "block"):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, g = loss_and_grads(model, tcfg[r], params, batch)
            torch.cuda.synchronize()
            peak[r] = torch.cuda.max_memory_allocated() / 2 ** 30
            grads[r] = (float(loss), tree_flatten(g), time.perf_counter() - t0)
            del g
        # the same two calls again, timed once more: the first pays
        # first-use costs (cuBLAS, lazily loaded kernels)
        again = {}
        for r in ("none", "block"):
            t0 = time.perf_counter()
            loss_and_grads(model, tcfg[r], params, batch)
            torch.cuda.synchronize()
            again[r] = time.perf_counter() - t0
        same = (grads["none"][0] == grads["block"][0] and
                all(torch.equal(a, b) for a, b in zip(grads["none"][1],
                                                      grads["block"][1])))
        check(same, f"{tag}: remat none and block gradients differ")
        log(f"{tag} {arch}: loss_and_grads on {TRAIN_SSM_B} x {TRAIN_SSM_T}, "
            f"remat none and block: loss {grads['none'][0]:.6f} both, every "
            f"one of {len(grads['none'][1])} gradient leaves bit-identical; "
            f"{grads['none'][2]:.3f} / {grads['block'][2]:.3f} s, again "
            f"{again['none']:.3f} / {again['block']:.3f} s, peak "
            f"{peak['none']:.2f} / {peak['block']:.2f} GiB")
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        kern = profile_counted(
            torch, f"{tag} {arch} remat block forward + backward",
            lambda: loss_and_grads(model, tcfg["block"], params, batch))
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        ev = kernel_events(kern, "ssd_intra_bwd")
        bwd_ms = sum(e.self_device_time_total for e in ev) / 1e3
        log(f"{tag} {arch} profile: ssd_intra_bwd {bwd_ms:.3f} ms x"
            f"{sum(e.count for e in ev)} of {busy_ms:.3f} ms device time "
            f"({bwd_ms / busy_ms:.1%} of the forward and backward)")
        out.update(peak_gib_no_remat=peak["none"],
                   fwd_bwd_s={r: again[r] for r in again},
                   ssd_intra_bwd_device_ms=bwd_ms, device_busy_ms=busy_ms)
    step = make_train_step(model, tcfg["block"], donate=True)
    opt = adamw_init(params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, gnorms, secs = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))          # synchronises
        gnorms.append(float(m["gnorm"]))
        secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses + gnorms)) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f"{tag} {arch}: the loss does not fall at every step: {losses}")
    check(peak < 80.0, f"{tag} {arch}: peak device memory {peak:.2f} GiB")
    # each layer's SSD forward runs three times under remat (the forward,
    # the super-block's recompute, the layer's recompute), its backward once;
    # a super-block's recompute stops once it has rebuilt what its backward
    # needs (torch.utils.checkpoint's early stop), so mamba2's one
    # super-block, which ends with a layer checkpointed on its own, does not
    # rerun that layer (zamba2's end with the shared block, which it needs)
    fwd = 3 * cfg.num_layers - (cfg.family == "ssm")
    want = {"ssd_intra": fwd * n_steps, "ssd_intra_bwd": cfg.num_layers * n_steps}
    check(all(launches[k] == n for k, n in want.items()),
          f"{tag} {arch}: launches {launches}, expected {want}")
    log(f"{tag} {arch} ({n_params} float32 parameters) {n_steps} steps of "
        f"{TRAIN_SSM_B} x {TRAIN_SSM_T}, remat block: loss "
        f"{', '.join(f'{x:.4f}' for x in losses)} (falling), gnorm "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}; s/step "
        f"{', '.join(f'{x:.3f}' for x in secs)} (host clock, each ending in "
        f"a sync; the first pays first-use costs); peak "
        f"device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches ssd_intra {launches['ssd_intra']}, ssd_intra_bwd "
        f"{launches['ssd_intra_bwd']}")
    out.update(losses=losses, gnorms=gnorms, s_per_step=secs, peak_gib=peak)
    del params, opt, step, batch
    # non-reentrant checkpoints leave reference cycles that hold their
    # inputs (views of the params) until the garbage collector runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def phase_train_ssm_fresh(torch):
    """``phase_train_ssm`` in a process of its own (``python3 chip_smoke.py
    --only train-ssm``), its lines passed on and its result read from its
    last line. Run after every serving phase in this process, its profile
    of one zamba2-2.7b forward and backward came one ``ssd_intra`` record
    short of 162, in both attempts, in most runs of the script, while the
    phase alone in a fresh process held; the check itself is unchanged."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--only", "train-ssm"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
    check(proc.returncode == 0 and bool(lines), f"[train-ssm] its process "
          f"exited with {proc.returncode}")
    return tuple(json.loads(lines[-1]))


def phase_train_ssm(torch, np):
    """[train-ssm] The SSD backward kernel against its plain version at
    zamba2's and mamba2's chunk shapes, then timed; zamba2-2.7b at full
    width and 6 layers, one train step's gradients on the card against the
    CPU's; full-width zamba2-2.7b (3 steps, remat none == block) and
    mamba2-1.3b (2 steps) trained in float32.
    → ({"ssd_intra_bwd": max abs err}, {"ssd_intra_bwd": timing},
       {path: launches})."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd_intra_bwd, ssd_intra_bwd_plain
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.tree import tree_flatten
    t_phase = time.perf_counter()
    err = 0.0
    timer = Timer(torch)
    timing = {}
    for i, label in enumerate(("zamba2", "mamba2")):
        shape = SSD_SHAPES[label]
        B, nc, Q, H, P, G, N = shape
        args = ssd_inputs(torch, shape, 40 + i)
        g = torch.Generator(device="cuda").manual_seed(50 + i)
        args += [torch.randn((B, nc, Q, H, P), generator=g, device="cuda"),
                 torch.randn((B, nc, H, N, P), generator=g, device="cuda")]
        got, want = ssd_intra_bwd(*args), ssd_intra_bwd_plain(*args)
        torch.cuda.synchronize()
        rel = {}
        for name, a, w in zip(("dxw", "dB", "dC", "dl"), got, want):
            rel[name], diff = rel_err(a, w)
            err = max(err, diff)
            check(rel[name] <= SSD_BWD_REL_TOL, f"[train-ssm] ssd_intra_bwd "
                  f"{label}: {name} relative error {rel[name]:.3g}")
        again = ssd_intra_bwd(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"[train-ssm] ssd_intra_bwd {label}: two launches differ")
        log(f"[parity] ssd_intra_bwd {label} (B, nc, Q, H, P, G, N) = {shape}: "
            f"max |kernel - plain| / max |plain|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f" (<= {SSD_BWD_REL_TOL}); two launches bit-identical")
        del got, want, again
        t = timer.turns({"ms": lambda: ssd_intra_bwd(*args),
                         "plain_ms": lambda: ssd_intra_bwd_plain(*args)})
        nbytes, flops = ssd_bwd_bound(shape)
        fma = bound_ms(nbytes, flops)
        t.update(library_ms=None, bound=split_tf32_bound_ms(nbytes, flops),
                 fma_bound_ms=fma[0])
        log(f"[timing] ssd_intra_bwd {label} {shape}: {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, library null, bound (split TF32 on "
            f"the tensor cores) {t['bound'][0]:.5f} ms ({t['bound'][1]}), "
            f"FMA bound {fma[0]:.5f} ms ({fma[1]}); bytes {nbytes}, flops "
            f"{flops}; {flops / t['ms'] / 1e9:.1f} TFLOP/s of the bound's "
            f"flops ({t['bound'][0] / t['ms']:.1%} of the split-TF32 bound)")
        timing[label] = t
        del args
    torch.cuda.empty_cache()
    lib = ops.build_kernels()["ssd_bwd"]
    n_hmma = sass_count(lib, "HMMA")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[train-ssm] {lib.name}: {n_hmma} HMMA instructions in its SASS "
        f"(cuobjdump -sass; None: no cuobjdump); ptxas: " + " | ".join(ptxas))
    timing["zamba2"]["sass_hmma"] = n_hmma

    # full width, 6 layers (one application of the shared block): the card
    # (the kernels) against the CPU (the plain versions)
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=6)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(60),
                        device="cuda", dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(61).integers(
        0, cfg.vocab_size, (1, TRAIN_SSM_T + 1)))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    tcfg = TrainConfig(remat="none", loss_chunk=None)
    side = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, tcfg, to_device(params, where),
                                     {k: x.to(where) for k, x in batch.items()})
        side[where] = (float(loss), [x.cpu() for x in tree_flatten(grads)],
                       time.perf_counter() - t0)
        del grads
    gerr, gmax = grads_close(torch, "[train-ssm] zamba2 6 layers card vs CPU",
                             side["cuda"][1], side["cpu"][1])
    lrel = abs(side["cuda"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    check(lrel <= 1e-5, f"[train-ssm] card vs CPU loss rel {lrel:.3g}")
    log(f"[train-ssm] zamba2-2.7b full width, 6 layers, 1 x {TRAIN_SSM_T}: "
        f"loss_and_grads on the card (kernels) vs the CPU (plain): max "
        f"|g_card - g_cpu| {gerr:.3g} <= 1e-4 x max |g| {gmax:.3g} over "
        f"{len(side['cpu'][1])} leaves; loss {side['cuda'][0]:.6f} vs "
        f"{side['cpu'][0]:.6f} (rel {lrel:.2g} <= 1e-5); "
        f"{side['cuda'][2]:.2f} s vs {side['cpu'][2]:.2f} s")
    del params, side
    gc.collect()
    torch.cuda.empty_cache()

    launches, summary = {}, {}
    launches["zamba2-2.7b train"], summary["zamba2-2.7b"] = ssm_train_run(
        torch, np, "[train-ssm]", "zamba2-2.7b", 3, 70, True)
    launches["mamba2-1.3b train"], summary["mamba2-1.3b"] = ssm_train_run(
        torch, np, "[train-ssm]", "mamba2-1.3b", 2, 71, False)
    log(f"[train-ssm] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"summary {json.dumps(summary)}")
    # checked last, so that a kernel without HMMAs still prints every line
    # above (its time, its profile share: the earlier design's numbers)
    check(n_hmma is None or n_hmma > 0, "[train-ssm] ssd_bwd's SASS holds no "
          "HMMA instruction: its products are not on the tensor cores")
    t = timing["zamba2"]
    t["at_mamba2_chunk"] = {k: timing["mamba2"][k] for k in
                            ("ms", "plain_ms", "library_ms", "fma_bound_ms")}
    t["at_mamba2_chunk"]["bound_ms"] = timing["mamba2"]["bound"][0]
    t["at_mamba2_chunk"]["bound_by"] = timing["mamba2"]["bound"][1]
    return {"ssd_intra_bwd": err}, {"ssd_intra_bwd": t}, launches


def zamba2_model(torch, np, tag, dtype=None):
    """Full-width zamba2-2.7b drawn on the card from a seeded CUDA
    generator in ``dtype`` (None: its config's bfloat16; 2.3 B
    parameters, their count and bytes logged under ``tag``), a random
    screen (r = 100, K = 16 of 250 tiles), its full-cover twin and 4
    prompts of 512 tokens. → dict (``rng`` goes on drawing inputs)."""
    from repro_torch.configs import get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves

    cfg = get_config("zamba2-2.7b")
    check((cfg.d_model, cfg.vocab_size) == (ZD, ZV),
          "config drifted from the smoke's shapes")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    n_bf16 = sum(t.numel() for t in leaves if t.dtype == torch.bfloat16)
    log(f"{tag} zamba2-2.7b: {n_params} parameters drawn on the card in "
        f"{t_init:.1f} s, {n_bf16} of them bfloat16: {nbytes / 1e9:.3f} GB; "
        f"device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(1)
    n_blk = -(-ZV // V_BLK)
    v = rng.standard_normal((R, ZD)).astype(np.float32)
    cand = make_screen_blocks(np, 8, n_blk)
    full_idx, full_len = candidates_to_padded(np.ones((R, n_blk), bool), ZV,
                                              block=V_BLK)
    return dict(model=model, params=params, rng=rng, n_params=n_params,
                n_bf16=n_bf16, nbytes=nbytes,
                screen=screen_from_numpy(v, cand, (cand < n_blk).sum(1), ZV,
                                         V_BLK),
                full=screen_from_numpy(v, full_idx, full_len, ZV, V_BLK),
                prompts=rng.integers(0, ZV, (ZB, ZT)))


def prefill_s(torch, model, params, prompts, max_len, dtype):
    """Host-clock seconds of one prefill of ``prompts`` into a fresh cache
    of ``max_len`` slots in ``dtype``."""
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), max_len, dtype=dtype,
                                 device="cuda")
        tokens = torch.as_tensor(prompts, device="cuda")
        _, t = host_timed(torch, lambda: model.prefill(
            params, {"tokens": tokens}, cache))
    return t


def prefill_decode_selfcheck(torch, z, dtype, tol, n=4):
    """The hidden states of a prefill over 512 tokens and ``n`` decode
    steps (a cache in ``dtype``) against one prefill over 512 + n: the max
    relative error, which must be at most ``tol``. → it."""
    model, params = z["model"], z["params"]
    seq = torch.as_tensor(z["rng"].integers(0, ZV, (ZB, ZT + n)),
                          device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(ZB, ZMAX, dtype=dtype, device="cuda")
        _, cache = model.prefill(params, {"tokens": seq[:, :ZT]}, cache)
        steps = []
        for i in range(n):
            h1, cache = model.decode_step(params, seq[:, ZT + i], cache,
                                          ZT + i)
            steps.append(h1)
        one, _ = model.forward(params, {"tokens": seq})
        want = one[:, ZT:].float()
        rel = float((torch.stack(steps, 1).float() - want).abs().max() /
                    want.abs().max())
    check(rel <= tol, f"prefill + decode != prefill ({dtype}): relative "
          f"error {rel:.3g} > {tol}")
    return rel


def phase_hybrid_f32(torch, np):
    """[hybrid f32] zamba2-2.7b drawn in float32 for the phases that keep
    it ([graph], [stream], [spec], adaptive, whose checks hold at the
    float32 gap rule): a prefill/decode self-check (max relative error
    <= 1e-3), and on the host clock the prefill of 4 x 512 and the decode
    step (median of 8 graph replays, screened-cuda) that [hybrid] prints
    beside bf16's. → the model dict, with those under "f32"."""
    from repro_torch.serving import DecodeEngine

    z = zamba2_model(torch, np, "[hybrid f32]", torch.float32)
    eng = DecodeEngine(z["model"], z["params"], screen=z["screen"],
                       max_len=ZMAX, device="cuda")
    eng.generate(z["prompts"][:, :16], 2, head="screened-cuda")  # warm-up
    rel = prefill_decode_selfcheck(torch, z, torch.float32, 1e-3)
    t_prefill = prefill_s(torch, z["model"], z["params"], z["prompts"], ZMAX,
                          torch.float32)
    step_ms = median_step_ms(torch, eng, "screened-cuda", z["prompts"], 8,
                             eager=False)
    log(f"[hybrid f32] self-check: prefill {ZT} + 4 decode steps vs prefill "
        f"{ZT + 4}: max relative error of the hidden states {rel:.3g} "
        f"(<= 1e-3); host clock, information only: prefill {ZB}x{ZT} "
        f"{t_prefill:.3f} s, decode step {step_ms:.3f} ms (median of 8 graph "
        f"replays, screened-cuda)")
    z["f32"] = dict(prefill_s=t_prefill, step_ms=step_ms)
    return z


def teacher_states(torch, model, params, prompts, tokens, max_len):
    """The hidden state before each greedy step that produced ``tokens``
    (B, n): a prefill of ``prompts`` and eager decode steps fed the tokens,
    through a bfloat16 cache of ``max_len`` slots, the shapes the engine
    ran (the graph replays run the same kernels). → (B, n, d)."""
    T = prompts.shape[1]
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), max_len, device="cuda")
        h, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompts, device="cuda")}, cache)
        hs = [h[:, -1]]
        for i in range(tokens.shape[1] - 1):
            h1, cache = model.decode_step(params, torch.as_tensor(
                tokens[:, i], device="cuda"), cache, T + i)
            hs.append(h1)
    return torch.stack(hs, 1)


def bf16_gap_rule(torch, np, tag, model, params, prompts, got, want,
                  max_len, gap_fn):
    """Each row of ``got`` equals ``want``'s, or first differs after a step
    whose deciding top-2 gap (``gap_fn`` of the hidden state the step saw,
    on ``want``'s path) is below GAP_BF16. → [(row, step, gap)] of the
    rows that differ; fails otherwise."""
    rows = [i for i in range(len(want))
            if not np.array_equal(got[i], want[i])]
    if not rows:
        return []
    H = teacher_states(torch, model, params, prompts, want, max_len)
    out = []
    for i in rows:
        t = int(np.nonzero(got[i] != want[i])[0][0])
        gap = float(gap_fn(H[i, t][None])[0])
        check(gap < GAP_BF16, f"{tag}: row {i} differs at step {t} with a "
              f"top-2 gap {gap:.4g} >= {GAP_BF16}")
        out.append((i, t, round(gap, 5)))
    return out


def screened_gap_fn(torch, eng):
    """The deciding top-2 gap of the plain screened head at hidden states
    h: the smaller of its candidates' (bf16 logits) and the route's."""
    from repro_torch.core.screening import screened_topk

    def gap(h):
        _, vals = screened_topk(eng.W, eng.b, eng.screen, h, 2)
        vals = vals.float()
        sc = (h.float() @ eng.screen.v.T).topk(2, dim=-1).values
        return torch.minimum(vals[:, 0] - vals[:, 1],
                             sc[:, 0] - sc[:, 1]).cpu().numpy()
    return gap


def phase_e2e_hybrid(torch, np, f32):
    """[hybrid] full-width zamba2-2.7b in its config's bfloat16 (2.3 B
    parameters drawn on the card, their bytes logged) on DecodeEngine(
    device="cuda", cache_dtype=bfloat16), so the route, gather and fused
    kernels run their bf16 bodies: greedy 4 prompts x 512 + 32 through
    exact, the plain `screened` head and screened-cuda (fused and
    unfused): fused == unfused tokens, screened-cuda == plain screened
    under the bf16 gap rule (GAP_BF16, on the plain head's bf16 candidate
    logits and the cluster scores along its own path); beam 4; a
    full-cover screen whose screened-cuda tokens equal exact's under the
    same rule (on the exact head's bf16 logits); and one prompt of 4,096
    tokens (the chunked attention path, 16 SSD chunks a layer; max_len
    4,160, 32 new) held to the plain `screened` head the same way.
    Counters from zero over those runs: ssd_intra 54 a prefill, the cache
    pair 9 a decode step, the bf16 L2S kernels launched and the float32
    ones not. Then a self-check (prefill 512 + 4 decode steps against one
    prefill of 516, max relative error <= 0.1: bf16 keeps 8 bits and 54
    layers round the residual stream), a profile (device calls == counted
    launches), and, on the host clock as information, the bf16 decode
    step (median of 8 graph replays) and prefill tokens/s beside
    float32's (``f32``), and the CUDA-event time of the float32 copies
    `_sdpa` makes of the 9 shared K/V caches a step. → launches of the
    path."""
    from repro_torch import heads
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine

    z = zamba2_model(torch, np, "[hybrid]")
    model, params, prompts = z["model"], z["params"], z["prompts"]
    cfg = model.cfg
    check(cfg.dtype == "bfloat16" and
          params["embed"]["embedding"].dtype == torch.bfloat16 and
          z["n_bf16"] / z["n_params"] > 0.999,
          "zamba2-2.7b: weights not in its config's bfloat16")
    log(f"[hybrid] bfloat16 weights {z['nbytes'] / 1e9:.3f} GB (A_log, D and "
        f"dt_bias float32; in float32 {4 * z['n_params'] / 1e9:.3f} GB)")
    long_prompt = z["rng"].integers(0, ZV, (1, ZLONG))
    kw = dict(cache_dtype=torch.bfloat16, device="cuda")
    eng = DecodeEngine(model, params, screen=z["screen"], max_len=ZMAX, **kw)
    eng_full = DecodeEngine(model, params, screen=z["full"], max_len=ZMAX,
                            **kw)
    eng_long = DecodeEngine(model, params, screen=z["screen"],
                            max_len=ZLONG_MAX, **kw)
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    packed = eng.resolve_head("screened-cuda")
    check(packed.prepare()._Wb.dtype == torch.bfloat16,
          "the packed head is not bfloat16")
    log(f"[hybrid] packed head {packed.packed_shape} bf16: "
        f"{packed.packed_nbytes / 1e6:.1f} MB")
    for e, p in ((eng, prompts), (eng_full, prompts),
                 (eng_long, long_prompt)):         # warm-up: loads, graphs
        e.generate(p[:, :16], 2, head="screened-cuda")
        e.generate(p[:, :16], 2, head="exact")
    t_prefill = prefill_s(torch, model, params, prompts, ZMAX, torch.bfloat16)
    t_prefill_long = prefill_s(torch, model, params, long_prompt, ZLONG_MAX,
                               torch.bfloat16)

    ops.reset_launches()
    exact, t_exact = host_timed(torch, lambda: eng.generate(prompts, ZNEW,
                                                            head="exact"))
    scr, t_scr = host_timed(torch, lambda: eng.generate(
        prompts, ZNEW, head="screened-cuda"))
    scr_u = eng.generate(prompts, ZNEW, head=unfused)
    beam, t_beam = host_timed(torch, lambda: eng.beam_search(
        prompts[0], 4, ZNEW, head="screened-cuda"))
    f_exact = eng_full.generate(prompts, ZNEW, head="exact")
    f_scr = eng_full.generate(prompts, ZNEW, head="screened-cuda")
    lg, t_long = host_timed(torch, lambda: eng_long.generate(
        long_prompt, ZNEW, head="screened-cuda"))
    launches = dict(ops.LAUNCHES)
    prefills = 7

    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u), ("long", lg)):
        check(r.tokens.shape[1] == ZNEW and r.tokens.min() >= 0 and
              r.tokens.max() < ZV, f"hybrid {name}: tokens out of range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          "hybrid: screened-cuda fused and unfused greedy tokens differ")
    check(beam.tokens.shape == (1, ZNEW) and np.isfinite(beam.scores).all(),
          "hybrid beam search: bad result")
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    check(launches["ssd_intra"] == cfg.num_layers * prefills and
          launches["cache_slot_update"] == n_attn * prefills * (ZNEW - 1),
          f"hybrid: launches {launches}, expected {cfg.num_layers} SSD a "
          f"prefill ({prefills}) and {n_attn} cache a decode step")
    check(all(launches[k] > 0 for k in BF16_KERNELS) and
          not any(launches[k] for k in L2S_KERNELS),
          f"hybrid: the L2S kernels' bf16 bodies did not carry the path: "
          f"{launches}")

    def exact_gap(h):
        top = (h @ eng.W.T + eng.b).float().topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).cpu().numpy()

    screened_gap = screened_gap_fn(torch, eng)
    plain = eng.generate(prompts, ZNEW, head="screened")
    near_plain = bf16_gap_rule(torch, np, "[hybrid] greedy against plain",
                               model, params, prompts, scr.tokens,
                               plain.tokens, ZMAX, screened_gap)
    near_full = bf16_gap_rule(torch, np, "[hybrid] full cover", model,
                              params, prompts, f_scr.tokens, f_exact.tokens,
                              ZMAX, exact_gap)
    plain_long = eng_long.generate(long_prompt, ZNEW, head="screened")
    near_long = bf16_gap_rule(torch, np, "[hybrid] 4,096-token prompt",
                              model, params, long_prompt, lg.tokens,
                              plain_long.tokens, ZLONG_MAX, screened_gap)
    rel = prefill_decode_selfcheck(torch, z, torch.bfloat16, 0.1)

    kern = profile_counted(torch, "[hybrid] greedy screened-cuda",
                           lambda: eng.generate(prompts, ZNEW,
                                                head="screened-cuda"))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    step_ms = median_step_ms(torch, eng, "screened-cuda", prompts, 8,
                             eager=False)
    long_step_ms = median_step_ms(torch, eng_long, "screened-cuda",
                                  long_prompt, 8, eager=False)

    # the float32 copies _sdpa makes of the shared K/V caches each step
    caches = [torch.zeros((ZB, ZMAX, cfg.num_kv_heads, cfg.head_dim),
                          dtype=torch.bfloat16, device="cuda")
              for _ in range(2)]
    a, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(20):
        for _ in range(n_attn):
            for c in caches:
                c.float()
    e_.record()
    e_.synchronize()
    upcast_ms = a.elapsed_time(e_) / 20
    del caches
    tok = ZB * ZNEW
    log(f"[hybrid] profile, greedy {ZB}x{ZT}+{ZNEW} screened-cuda: device "
        f"busy {busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall "
        f"(idle share {1 - busy_ms / (t_scr * 1e3):.3f}), "
        f"{sum(e.count for e in kern)} device kernels; "
        f"{fused_share(kern, busy_ms, 'fused_screened_topk_bf16')}; top "
        f"kernels: " +
        "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top))
    log(f"[hybrid] zamba2-2.7b d={ZD} V={ZV} bf16 on DecodeEngine("
        f"device='cuda', max_len={ZMAX}, cache_dtype=bfloat16): greedy "
        f"{ZB}x{ZT}+{ZNEW} exact {t_exact:.3f} s ({tok / t_exact:.1f} tok/s), "
        f"screened-cuda {t_scr:.3f} s ({tok / t_scr:.1f} tok/s), beam(4) "
        f"{t_beam:.3f} s; fused == unfused tokens; screened-cuda == the "
        f"plain screened head's except rows first differing after a step "
        f"with a gap < {GAP_BF16}: {near_plain}; beam score "
        f"{float(beam.scores[0]):.4f}")
    log(f"[hybrid] host clock, information only: decode step (median of 8 "
        f"graph replays, B={ZB}, screened-cuda) {step_ms:.3f} ms in bf16 "
        f"against {f32['step_ms']:.3f} ms in float32; prefill {ZB}x{ZT} "
        f"{t_prefill:.3f} s ({ZB * ZT / t_prefill:.0f} tok/s) against "
        f"{f32['prefill_s']:.3f} s ({ZB * ZT / f32['prefill_s']:.0f} tok/s); "
        f"float32 copies of the {n_attn} shared K/V cache pairs (the upcast "
        f"in _sdpa) {upcast_ms:.4f} ms a step (CUDA events), "
        f"{upcast_ms / step_ms:.1%} of the bf16 step")
    log(f"[hybrid] one prompt of {ZLONG} tokens (chunked attention, "
        f"{ZLONG // cfg.ssm.chunk} SSD chunks a layer), max_len {ZLONG_MAX}, "
        f"{ZNEW} new through screened-cuda: prefill alone {t_prefill_long:.3f} "
        f"s ({ZLONG / t_prefill_long:.0f} tok/s), generate {t_long:.3f} s, "
        f"decode step {long_step_ms:.3f} ms (median of 8); tokens == the "
        f"plain screened head's except rows first differing after a step "
        f"with a gap < {GAP_BF16}: {near_long}")
    log(f"[hybrid] full-cover screen (K={z['full'].c_max}): screened-cuda == "
        f"exact under the bf16 gap rule (< {GAP_BF16}); rows that differ "
        f"(row, step, gap): {near_full}")
    log(f"[hybrid] self-check: prefill {ZT} + 4 decode steps vs prefill "
        f"{ZT + 4}: max relative error of the hidden states {rel:.3g} "
        f"(<= 0.1)")
    log(f"[hybrid] launches on the hybrid path ({prefills} prefills): "
        f"{json.dumps(launches)}")
    return launches


def phase_ssm_bf16(torch, np):
    """[ssm bf16] full-width mamba2-1.3b (48 Mamba2 layers, d = 2048,
    V = 50,280: 393 tiles) in its config's bfloat16, drawn on the card, on
    DecodeEngine(device="cuda"): greedy 4 prompts x 512 + 32 through exact
    and screened-cuda fused and unfused (r = 100, K = 16; fused == unfused
    tokens), and the plain `screened` head, which screened-cuda's tokens
    equal under the bf16 gap rule (GAP_BF16). Counters from zero over the
    port's runs: ssd_intra 48 a prefill (mamba2's chunk shape), no cache
    launch (attention-free), the bf16 L2S bodies launched and the float32
    ones not. The bf16 decode step (median of 8 graph replays) and the
    prefill on the host clock, as information. → launches of the path."""
    from repro_torch import heads
    from repro_torch.configs import get_config
    from repro_torch.interop import screen_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-1.3b")
    d, vocab = cfg.d_model, cfg.vocab_size
    check((d, vocab) == (MD, MV), "config drifted from the smoke's shapes")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    check(params["embed"]["embedding"].dtype == torch.bfloat16,
          "mamba2-1.3b: weights not in bfloat16")
    rng = np.random.default_rng(3)
    n_blk = -(-vocab // V_BLK)
    v = rng.standard_normal((R, d)).astype(np.float32)
    cand = make_screen_blocks(np, 9, n_blk)
    screen = screen_from_numpy(v, cand, (cand < n_blk).sum(1), vocab, V_BLK)
    prompts = rng.integers(0, vocab, (ZB, ZT))
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       cache_dtype=torch.bfloat16, device="cuda")
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    for head in ("screened-cuda", "exact", unfused):   # warm-up: graphs
        eng.generate(prompts[:, :16], 2, head=head)
    t_prefill = prefill_s(torch, model, params, prompts, ZMAX, torch.bfloat16)
    ops.reset_launches()
    exact, t_exact = host_timed(torch, lambda: eng.generate(prompts, ZNEW,
                                                            head="exact"))
    scr, t_scr = host_timed(torch, lambda: eng.generate(
        prompts, ZNEW, head="screened-cuda"))
    scr_u = eng.generate(prompts, ZNEW, head=unfused)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u)):
        check(r.tokens.shape == (ZB, ZNEW) and r.tokens.min() >= 0 and
              r.tokens.max() < vocab, f"ssm bf16 {name}: tokens out of range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          "ssm bf16: screened-cuda fused and unfused greedy tokens differ")
    near = bf16_gap_rule(torch, np, "[ssm bf16] greedy against plain", model,
                         params, prompts, scr.tokens,
                         eng.generate(prompts, ZNEW, head="screened").tokens,
                         ZMAX, screened_gap_fn(torch, eng))
    check(launches["ssd_intra"] == cfg.num_layers * 3 and
          launches["cache_slot_update"] == 0 and
          all(launches[k] > 0 for k in BF16_KERNELS) and
          not any(launches[k] for k in L2S_KERNELS),
          f"ssm bf16: launches {launches}, expected {cfg.num_layers} SSD a "
          f"prefill, no cache launch and only the bf16 L2S bodies")
    step_ms = median_step_ms(torch, eng, "screened-cuda", prompts, 8,
                             eager=False)
    tok = ZB * ZNEW
    log(f"[ssm bf16] mamba2-1.3b: {sum(t.numel() for t in leaves)} "
        f"parameters, {sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
        f"GB in bfloat16, on DecodeEngine(device='cuda'): greedy "
        f"{ZB}x{ZT}+{ZNEW} exact {t_exact:.3f} s ({tok / t_exact:.1f} tok/s), "
        f"screened-cuda {t_scr:.3f} s ({tok / t_scr:.1f} tok/s); fused == "
        f"unfused tokens, == the plain screened head's except rows first "
        f"differing after a step with a gap < {GAP_BF16}: {near}; prefill "
        f"{ZB}x{ZT} {t_prefill:.3f} s ({ZB * ZT / t_prefill:.0f} tok/s), "
        f"decode step {step_ms:.3f} ms "
        f"(median of 8 graph replays; host clock, information only); "
        f"launches: {json.dumps(launches)}")
    return launches


UNFUSED = "screened-cuda-unfused"
HEADS3 = ("exact", "screened-cuda", UNFUSED)


def register_unfused():
    """The unfused screened-cuda head under a registry name of its own, so
    that routing and compiled_step_counts tell it from the fused one."""
    from repro_torch import heads

    def build(W, b, screen=None, **_):
        head = heads.ScreenedCudaHead(W, b, screen, fused=False)
        head.name = UNFUSED
        return head
    heads.register(UNFUSED, build)


def host_timed(torch, fn):
    """(fn's result, host-clock seconds of fn ending in a synchronise)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t


def median_step_ms(torch, eng, head, prompts, n, eager):
    """Median host-clock time of ``n`` greedy decode steps, each ending in
    a synchronise: graph replays, or (``eager``) the step body run as it
    is."""
    with torch.inference_mode():
        hd = eng.resolve_head(head)
        slab, h = eng._prefill(prompts, n + 1)
        slab.tok.copy_(hd.next(h))
        step = eng._greedy_step(hd)
        times = []
        for _ in range(n):
            _, t = host_timed(torch, lambda: step.body(slab) if eager
                              else eng._run(step, slab))
            times.append(t * 1e3)
    return statistics.median(times)


def device_profile(torch, tag, fn, wall_s):
    """Profile one call of ``fn`` (``profile_counted``) → (device busy ms,
    idle share against the unprofiled wall ``wall_s``, {kernel: (device ms,
    calls)} of the port's kernels, device kernels in all)."""
    kern = profile_counted(torch, tag, fn)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ours = {}
    for name in KERNEL_NAMES:
        ev = kernel_events(kern, name)
        if ev:
            ours[name] = (sum(e.self_device_time_total for e in ev) / 1e3,
                          sum(e.count for e in ev))
    return (busy, 1 - busy / (wall_s * 1e3), ours,
            sum(e.count for e in kern))


def phase_graph(torch, np, tag, eng, prompts, new, beam, sampled):
    """[graph] on one full-width path, on a fresh engine: the eager step
    bodies (``repro_torch.testing``) and then the engine's CUDA graphs
    decode greedy (and, with ``sampled``, sampled: T = 1 on each head, and
    top-p 0.9 on screened-cuda) 4 prompts and beam search, through exact
    and screened-cuda fused and unfused. Tokens, beams and launch counts
    (each side counted from zero) must be equal, and sampled tokens equal
    the head's own ``sample`` draws; one graph per (head, kind) at this
    width. Then graph against eager: host-clock tokens/s, median step time,
    and profiled idle share and per-launch device time of the port's
    kernels, whose device calls must equal the counted launches. →
    launches of the graph runs."""
    from repro_torch.kernels import ops
    from repro_torch.testing import (eager_beam_search, eager_generate,
                                     head_sampled_generate)
    B = len(prompts)
    runs = [(name, {}) for name in HEADS3]
    if sampled:
        runs += [(name, dict(temperature=1.0, seed=21)) for name in HEADS3]
        runs.append(("screened-cuda", dict(temperature=1.0, top_p=0.9,
                                           seed=22)))

    def key(name, kw):
        return (name,) + tuple(sorted(kw.items()))

    # the slabs (static caches) of both widths are held across both sides,
    # so the memory figure below is the graph pools' own: without a graph
    # a slab lives for one call only
    with torch.inference_mode():
        slabs = [eng._slab(w) for w in {B, beam}]
    ops.reset_launches()
    eager = {key(n, kw): eager_generate(eng, prompts, new, head=n, **kw)
             for n, kw in runs}
    eager_beam = {n: eager_beam_search(eng, prompts[0], beam, new, head=n)
                  for n in HEADS3}
    torch.cuda.synchronize()
    eager_launches = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    ops.reset_launches()
    got = {key(n, kw): eng.generate(prompts, new, head=n, **kw)
           for n, kw in runs}
    got_beam = {n: eng.beam_search(prompts[0], beam, new, head=n)
                for n in HEADS3}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    pools = torch.cuda.memory_reserved() - mem0[0]
    held = torch.cuda.memory_allocated() - mem0[1]
    del slabs

    for k, want in eager.items():
        check(np.array_equal(got[k].tokens, want.tokens),
              f"[graph] {tag} {k}: graph tokens differ from the eager step "
              f"body's")
    for n, want in eager_beam.items():
        check(np.array_equal(got_beam[n].tokens, want.tokens) and
              np.array_equal(got_beam[n].scores, want.scores),
              f"[graph] {tag} beam {n}: graph beam differs from eager")
    check(launches == eager_launches,
          f"[graph] {tag}: graph runs launched {launches}, the eager step "
          f"bodies {eager_launches}")
    for n, kw in runs:
        if kw:
            own = head_sampled_generate(eng, prompts, new, n,
                                        kw["temperature"],
                                        kw.get("top_p", 1.0), kw["seed"])
            check(np.array_equal(got[key(n, kw)].tokens, own),
                  f"[graph] {tag} {key(n, kw)}: graph-sampled tokens differ "
                  f"from the head's own sample(h, generator=...) draws")
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[graph] {tag}: a kernel never launched: {launches}")
    counts = eng.compiled_step_counts()
    want = {(n, kind): 1 for n in HEADS3 for kind in ("greedy", "decode")}
    if sampled:
        want.update({(n, "sample"): 1 for n in HEADS3})
        want[("screened-cuda", "sample")] = 2
    check(counts == want, f"[graph] {tag}: compiled_step_counts {counts}, "
          f"expected {want}")
    per_replay = {f"{s_key[0][0]}/{s_key[1]}" + (
        f"/T={s_key[2]},top_p={s_key[3]}" if s_key[1] == "sample" else "") +
        f"/B={w}": g.launches
        for s_key, step in eng._step_cache.items()
        for w, g in step.graphs.items()}

    name = "screened-cuda"
    _, t_graph = host_timed(torch, lambda: eng.generate(prompts, new,
                                                        head=name))
    _, t_eager = host_timed(torch, lambda: eager_generate(eng, prompts, new,
                                                          head=name))
    _, t_gx = host_timed(torch, lambda: eng.generate(prompts, new,
                                                     head="exact"))
    _, t_ex = host_timed(torch, lambda: eager_generate(eng, prompts, new,
                                                       head="exact"))
    step_g = median_step_ms(torch, eng, name, prompts, min(new, 24), False)
    step_e = median_step_ms(torch, eng, name, prompts, min(new, 24), True)
    prof_g = device_profile(torch, f"[graph] {tag} graph", lambda:
                            eng.generate(prompts, new, head=name), t_graph)
    prof_e = device_profile(torch, f"[graph] {tag} eager", lambda:
                            eager_generate(eng, prompts, new, head=name),
                            t_eager)
    tok = B * new
    log(f"[graph] {tag}: graph == eager step body, bit for bit: greedy "
        f"{B}x{new} and beam({beam}) through {', '.join(HEADS3)}" +
        (", sampled T=1 on each and top-p 0.9 on screened-cuda (same seeds; "
         "== the head's own sample draws)"
         if sampled else "") + f"; launches (graph runs == eager runs, each "
        f"from zero): {json.dumps(launches)}")
    log(f"[graph] {tag}: compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }; "
        f"launches per replay: {json.dumps(per_replay)}")
    log(f"[graph] {tag}: graph pools add {pools / 2 ** 20:.1f} MiB reserved "
        f"({held / 2 ** 20:.1f} MiB of graph outputs held), after the eager "
        f"runs of the same work")
    log(f"[graph] {tag}: greedy {B}x{new} (prefill included) screened-cuda "
        f"graph {tok / t_graph:.1f} tok/s vs eager {tok / t_eager:.1f} tok/s "
        f"(exact {tok / t_gx:.1f} vs {tok / t_ex:.1f}); median decode step "
        f"(synchronised) graph {step_g:.4f} ms vs eager {step_e:.4f} ms "
        f"(host clock, information only)")
    for label, (busy, idle, ours, n_kern), wall in (
            ("graph", prof_g, t_graph), ("eager", prof_e, t_eager)):
        log(f"[graph] {tag} profile {label}, greedy screened-cuda: device "
            f"busy {busy:.3f} ms of {wall * 1e3:.3f} ms unprofiled wall "
            f"(idle share {idle:.3f}), {n_kern} device kernels; per launch: "
            + "; ".join(f"{k} {ms / n * 1e3:.2f} us x{n}"
                        for k, (ms, n) in ours.items()))
    return launches


def launch_costs(torch, np):
    """What a launch costs inside a graph: each kernel at its decode shape
    timed (clean-L2 Timer) as one eager launch, one graph replay of one
    launch, and one replay of a graph of 9 launches (per launch; the cache
    pair's 9 are one zamba2 decode step's)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cache_update import cache_kv_update
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.route import cluster_route
    from repro_torch.kernels.screen import screened_logits
    timer = Timer(torch)
    W, b = make_head(torch, 1)
    Wb, bb = ops.pack_head_blocks(W, b)
    cand = torch.from_numpy(make_screen_blocks(np, 3, Wb.shape[0])).cuda()
    g = torch.Generator().manual_seed(9)
    v = torch.randn((R, D), generator=g).cuda()
    h = torch.randn((4, D), generator=g).cuda()
    ids = cand[cluster_route(h, v).long()].contiguous()
    ck, cv = (torch.zeros(CACHE_SHAPE, device="cuda") for _ in range(2))
    uk, uv = (torch.randn(CACHE_SHAPE[:1] + CACHE_SHAPE[2:], generator=g)
              .cuda() for _ in range(2))
    slots = torch.full((CACHE_SHAPE[0],), 300, dtype=torch.int32,
                       device="cuda")
    fns = {"cluster_route": lambda: cluster_route(h, v),
           "screened_logits": lambda: screened_logits(Wb, bb, h, ids),
           "fused_screened_topk": lambda: fused_screened_topk(Wb, bb, h, ids,
                                                              1),
           "cache_slot_update": lambda: cache_kv_update(ck, uk, cv, uv,
                                                        slots)}
    stream = torch.cuda.Stream()
    out = {}
    for name, fn in fns.items():
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graphs = {}
        for n in (1, 9):
            graphs[n] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[n], stream=stream):
                for _ in range(n):
                    fn()
        t = timer.turns({"eager": fn, "graph": graphs[1].replay,
                         "graph9": graphs[9].replay})
        out[name] = dict(eager=t["eager"], graph=t["graph"],
                         graph9=t["graph9"] / 9)
        log(f"[graph] launch cost, {name} (clean-L2 timer): eager "
            f"{t['eager']:.5f} ms, one-launch graph {t['graph']:.5f} ms, "
            f"graph of 9 {t['graph9'] / 9:.5f} ms per launch")
    return out


def phase_serve(torch, np, ctx):
    """[serve] on full-width nmt-deen-lstm: 16 ServeRequests (greedy and
    sampled, k = 1 and 5, prompts of 8 and 12 tokens, accuracy floors 0
    and 1) routed by a CostAwarePolicy over screened-cuda fused, unfused
    and exact, one with an explicit head; greedy results equal solo
    generate calls, and a second identical serve_batch adds no graph.
    → launches of the first serve_batch."""
    from repro_torch.kernels import ops
    from repro_torch.serving import CostAwarePolicy, DecodeEngine, ServeRequest
    eng = DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                       device="cuda")
    rng = np.random.default_rng(16)
    reqs = []
    for i in range(16):
        sampled = i % 4 == 1
        reqs.append(ServeRequest(
            prompt=rng.integers(0, V, 8 if i % 2 == 0 else 12),
            max_new=8 + i % 5, k=5 if i % 3 == 0 else 1,
            accuracy_floor=1.0 if i % 5 == 2 else 0.0,
            temperature=0.9 if sampled else None,
            top_p=0.95 if i == 5 else 1.0, seed=100 + i,
            head=UNFUSED if i == 15 else None))
    pol = CostAwarePolicy(["screened-cuda", UNFUSED, "exact"],
                          accuracy={UNFUSED: 0.99})
    ops.reset_launches()
    first, t_first = host_timed(torch, lambda: eng.serve_batch(reqs, pol))
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    again, t_again = host_timed(torch, lambda: eng.serve_batch(reqs, pol))
    check(eng.compiled_step_counts() == counts,
          f"[serve] the second serve_batch added graphs: {counts} -> "
          f"{eng.compiled_step_counts()}")
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[serve] a kernel never launched: {launches}")
    heads_used = sorted({r.head for r in first})
    check(heads_used == sorted(HEADS3), f"[serve] routes {heads_used}")
    for req, a, b in zip(reqs, first, again):
        check(np.array_equal(a.tokens, b.tokens) and
              a.tokens.shape == (req.max_new,) and a.tokens.max() < V,
              "[serve] a repeated serve_batch changed a result")
        if not req.sampled:
            solo = eng.generate(req.prompt[None], req.max_new, head=a.head)
            check(np.array_equal(solo.tokens[0], a.tokens),
                  f"[serve] request for {a.head} differs from solo generate")
    groups = len({r.group_key(a.head) for r, a in zip(reqs, first)})
    log(f"[serve] nmt-deen-lstm: 16 requests in {groups} groups routed to "
        f"{ {h: sum(r.head == h for r in first) for h in heads_used} }; "
        f"greedy results == solo generate; second identical serve_batch "
        f"adds 0 graphs (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }); "
        f"serve_batch {t_first:.3f} s first (captures included), "
        f"{t_again:.3f} s again (host clock, information only); launches: "
        f"{json.dumps(launches)}")
    return launches


# -- training side: the LM trainer and Algorithm 1 -------------------------------
TRAIN_B, TRAIN_T, TRAIN_STEPS = 32, 64, 300
N_CTX, N_FIT = 100_000, 90_000
TOP_GAP = 1e-5


def plain_topk_rows(torch, np, W, b, screen, H, k, batch=256):
    """The plain block screened head (``core/screening.py``) over H in
    batches on the card → (ids (N, k), smallest gap between its k + 1
    largest candidate logits (N,))."""
    from repro_torch.core.screening import screened_topk
    ids, gaps = [], []
    with torch.inference_mode():
        for i in range(0, len(H), batch):
            h = torch.as_tensor(H[i:i + batch], device="cuda")
            got, vals = screened_topk(W, b, screen, h, k + 1)
            ids.append(got[:, :k].cpu().numpy())
            gaps.append((vals[:, :-1] - vals[:, 1:]).min(dim=1).values
                        .cpu().numpy())
    return np.concatenate(ids), np.concatenate(gaps)


def phase_train_l2s(torch, np):
    """[train] / [l2s] on full-width nmt-deen-lstm: train the LM on the
    synthetic corpus (300 steps of 32 x 64 tokens; one step held against the
    CPU's), harvest 100,000 contexts, fit a 128-word block screen with
    ``fit_l2s`` (and the k-means-only ablation), then hold it to the exact
    head on 10,000 held-out contexts through the CUDA kernels and decode
    with it. → (launches of the evaluation and decode through the fitted
    screen, counted from zero; the trained model, params and screen)."""
    from repro_torch import heads
    from repro_torch.configs import L2SConfig, TrainConfig, get_config
    from repro_torch.core import collect_contexts, fit_l2s, precision_at_k
    from repro_torch.core.evaluate import (avg_candidate_size, exact_topk,
                                           speedup_model)
    from repro_torch.core.screening import assign_clusters
    from repro_torch.core.train_l2s import kmeans_only_screen
    from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.route import cluster_route
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.optim import adamw_init, clip_by_global_norm
    from repro_torch.serving import DecodeEngine
    from repro_torch.tree import tree_flatten
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    corpus = ZipfMarkovCorpus(V, branching=64, seed=0)
    log(f"[train] ZipfMarkovCorpus({V}, branching=64) built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = get_config("nmt-deen-lstm")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(17),
                        device="cuda")
    tcfg = TrainConfig(lr=2e-3, warmup_steps=20, total_steps=TRAIN_STEPS,
                       remat="none", loss_chunk=None)
    batches = list(BatchLoader(make_lm_batches(corpus, TRAIN_STEPS, TRAIN_B,
                                               TRAIN_T, seed=1), "cuda"))

    # one step's gradients, loss and gnorm on the card against the CPU's
    cpu_params = to_device(params, "cpu")
    cpu_batch = {k: x.cpu() for k, x in batches[0].items()}
    side = {}
    for where, p, bt in (("card", params, batches[0]),
                         ("cpu", cpu_params, cpu_batch)):
        loss, grads = loss_and_grads(model, tcfg, p, bt)
        _, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        side[where] = (float(loss), float(gnorm),
                     [g.cpu() for g in tree_flatten(grads)])
    gmax = max(float(g.abs().max()) for g in side["cpu"][2])
    gerr = max(float((a - c).abs().max())
               for a, c in zip(side["card"][2], side["cpu"][2]))
    lrel = abs(side["card"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    nrel = abs(side["card"][1] - side["cpu"][1]) / abs(side["cpu"][1])
    check(gerr <= 1e-4 * gmax and lrel <= 1e-5 and nrel <= 1e-5,
          f"[train] card vs CPU step: max |dg| {gerr:.3g} (limit "
          f"{1e-4 * gmax:.3g}), loss rel {lrel:.3g}, gnorm rel {nrel:.3g}")
    log(f"[train] one step on the card vs the CPU from the same params and "
        f"batch: max |g_card - g_cpu| {gerr:.3g} <= 1e-4 x max |g| "
        f"{gmax:.3g}; loss {side['card'][0]:.6f} vs {side['cpu'][0]:.6f} "
        f"(rel {lrel:.2g}), gnorm {side['card'][1]:.6f} vs "
        f"{side['cpu'][1]:.6f} (rel {nrel:.2g}), each <= 1e-5")
    del cpu_params, cpu_batch, side

    step = make_train_step(model, tcfg)
    opt = adamw_init(params)
    losses, gnorms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for bt in batches:
        params, opt, m = step(params, opt, bt)
        losses.append(m["loss"])
        gnorms.append(m["gnorm"])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    gnorms = torch.stack(gnorms).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(np.isfinite(gnorms).all() and np.isfinite(losses).all(),
          "[train] a loss or gnorm is not finite")
    check(last < first, f"[train] loss did not fall: first 20 steps "
          f"{first:.4f}, last 20 {last:.4f}")
    log(f"[train] nmt-deen-lstm d={D} V={V}: {TRAIN_STEPS} steps of "
        f"{TRAIN_B}x{TRAIN_T} tokens (lr 2e-3, warmup 20, cosine), mean loss "
        f"first 20 steps {first:.4f} -> last 20 {last:.4f}, gnorm "
        f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f} (all finite); "
        f"{t_train / TRAIN_STEPS:.4f} s/step (synchronised host clock), "
        f"peak device memory {peak / 2 ** 30:.2f} GiB")
    # the corpus's unigram counts (the training tokens), for [heads]
    counts = torch.bincount(torch.cat([bt["tokens"].reshape(-1)
                                       for bt in batches]),
                            minlength=V).cpu().numpy()
    del batches, opt

    t0 = time.perf_counter()
    tokens = [b["tokens"] for b in BatchLoader(make_lm_batches(
        corpus, -(-N_CTX // (TRAIN_B * TRAIN_T)), TRAIN_B, TRAIN_T, seed=99),
        "cuda")]
    H, y = collect_contexts(model, params, tokens, max_vectors=N_CTX, k=5)
    Hfit, yfit, Hte = H[:N_FIT], y[:N_FIT], H[N_FIT:]
    log(f"[l2s] harvested {len(H)} contexts (exact top-5) in "
        f"{time.perf_counter() - t0:.1f} s; {N_FIT} to fit, {len(Hte)} held "
        f"out")

    lcfg = L2SConfig(num_clusters=R, budget=1024, vocab_block=V_BLK,
                     outer_iters=4, sgd_steps=200, batch_size=512)
    t0 = time.perf_counter()
    state = fit_l2s(Hfit, yfit, V, lcfg, verbose=True, device="cuda")
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    km = kmeans_only_screen(Hfit, yfit, V, lcfg, device="cuda")
    t_km = time.perf_counter() - t0
    cov = state.history[-1]["coverage_best"]
    rounds = state.history[:-1]
    log(f"[l2s] fit_l2s (r={R}, budget 1024, block {V_BLK}, 4 rounds x 200 "
        f"v-steps of 512) in {t_fit:.1f} s: best coverage {cov:.6f}; per "
        f"round (loss, Lbar, coverage, c-step s, v-step ms): " +
        "; ".join(f"{h['loss']:.4f}, {h['lbar']:.1f}, {h['coverage']:.6f}, "
                  f"{h['cstep_s']:.3f}, {h['vstep_s'] * 1e3:.3f}"
                  for h in rounds) +
        f"; kmeans_only_screen in {t_km:.1f} s")

    W, b = model.softmax_weights(params)
    screen = state.screen
    n_blk = -(-V // V_BLK)

    # the route kernel's clusters on the fitting contexts give back the
    # fit's coverage, up to rows whose top-2 cluster scores nearly tie
    with torch.inference_mode():
        hf = torch.as_tensor(Hfit, device="cuda")
        plain = assign_clusters(screen.v, hf)
        kern = cluster_route(hf, screen.v)
        scores = torch.topk(hf @ screen.v.T, 2, dim=-1).values
        rel = ((scores[:, 0] - scores[:, 1]) /
               scores[:, 0].abs().clamp(min=1e-30)).cpu().numpy()
        plain, kern = plain.cpu().numpy(), kern.cpu().numpy()
    del hf
    items = yfit // V_BLK
    hits = state.mask[kern][np.arange(N_FIT)[:, None], items].sum()
    near = rel < 1e-5
    moved = kern != plain
    check(not (moved & ~near).any(),
          f"[l2s] the route kernel moved {int(moved.sum())} fitting rows, "
          f"some with top-2 cluster scores apart by >= 1e-5 relative")
    cov_k = hits / yfit.size
    check(abs(hits - round(cov * yfit.size)) <= 5 * int(near.sum()),
          f"[l2s] coverage through the route kernel {cov_k:.6f}, fit_l2s "
          f"reported {cov:.6f}, {int(near.sum())} near-tie rows")
    log(f"[l2s] cluster_route on the {N_FIT} fitting contexts: coverage "
        f"{cov_k:.6f} (fit_l2s reported {cov:.6f}); {int(moved.sum())} rows "
        f"routed otherwise than torch.argmax, all among the "
        f"{int(near.sum())} near-ties (< 1e-5 relative)")

    # held-out evaluation: exact, the plain screened head, screened-cuda
    # fused and unfused, counted from zero with the decode below
    exact = heads.get("exact", W=W, b=b, device="cuda")
    fused = heads.get("screened-cuda", W=W, b=b, screen=screen,
                      device="cuda")
    unfused = heads.get("screened-cuda", W=W, b=b, screen=screen,
                        fused=False, device="cuda")
    hte = torch.as_tensor(Hte, device="cuda")
    ex = exact_topk(W, b, Hte, 5)
    plain_ids, gaps = plain_topk_rows(torch, np, W, b, screen, Hte, 5)
    ops.reset_launches()
    with torch.inference_mode():
        f_ids = fused.topk(hte, 5)[0].cpu().numpy()
        u_ids = unfused.topk(hte, 5)[0].cpu().numpy()
    check(np.array_equal(f_ids, u_ids),
          "[l2s] screened-cuda fused and unfused ids differ")
    mapped = np.where(plain_ids >= V, n_blk * V_BLK, plain_ids)
    bad = np.nonzero((f_ids != mapped).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(),
          f"[l2s] screened-cuda differs from the plain screened head on "
          f"{len(bad)} rows, some with a top-k gap >= {TOP_GAP}")
    km_head = heads.get("screened-cuda", W=W, b=b, screen=km.screen,
                        device="cuda")
    with torch.inference_mode():
        km_ids = km_head.topk(hte, 5)[0].cpu().numpy()
    p = {name: (precision_at_k(ids[:, :1], ex[:, :1]),
                precision_at_k(ids, ex))
         for name, ids in (("l2s", f_ids), ("kmeans", km_ids))}
    lbar = avg_candidate_size(screen, Hte)
    lbar_km = avg_candidate_size(km.screen, Hte)
    log(f"[l2s] held-out {len(Hte)}: screened-cuda fused == unfused ids; == "
        f"the plain screened head (sentinels mapped) except {len(bad)} rows "
        f"with a top-k gap < {TOP_GAP}; {len(np.unique(ex[:, 0]))} distinct "
        f"exact top-1 ids, {len(np.unique(ex))} distinct in the top-5")
    log(f"[l2s] P@1 / P@5 against exact: L2S {p['l2s'][0]:.4f} / "
        f"{p['l2s'][1]:.4f} (Lbar {lbar:.1f} words, analytic speedup "
        f"{speedup_model(V, D, R, lbar):.1f}x); k-means only "
        f"{p['kmeans'][0]:.4f} / {p['kmeans'][1]:.4f} (Lbar {lbar_km:.1f}, "
        f"{speedup_model(V, D, R, lbar_km):.1f}x)")

    # the fitted screen in the decode engine (graphs), greedy 4 x 16
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    prompts = corpus.sample_batch(4, 8, seed=7)
    g_exact = eng.generate(prompts, 16, head="exact")
    g_scr = eng.generate(prompts, 16, head="screened-cuda")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["cluster_route"] > 0 and launches["fused_screened_topk"] > 0,
          f"[l2s] a kernel never launched: {launches}")
    agree = float((g_exact.tokens == g_scr.tokens).mean())
    log(f"[l2s] DecodeEngine greedy 4x16 with the fitted screen: screened-cuda "
        f"== exact on {agree:.4f} of tokens; launches (evaluation and decode, "
        f"from zero): {json.dumps(launches)}")

    timer = Timer(torch, reps=10)
    out = {}
    for B in (1, len(Hte)):
        h = hte[:B].contiguous()
        with torch.inference_mode():
            t = timer.turns({"exact": lambda: exact.topk(h, 5),
                             "screened-cuda": lambda: fused.topk(h, 5)})
        out[B] = t
        log(f"[l2s] head time, B={B}, k=5 (CUDA events, clean L2): exact "
            f"{t['exact']:.5f} ms, screened-cuda {t['screened-cuda']:.5f} ms "
            f"(ratio {t['exact'] / t['screened-cuda']:.2f})")
    log(f"[l2s] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(model=model, params=params, screen=screen,
                          corpus=corpus, Hte=Hte, exact_top5=ex,
                          counts=counts)


# -- continuous batching: streams, the scheduler, the launcher --------------------
SCHED_N = 48                    # [sched] requests, tiers round-robin
LSTM_W, ZSTREAM_W = 8, 4        # stream widths


def gap_steps(torch, np, model, params, screen, prompt, tokens, head):
    """The top-2 gaps that decide each of ``head``'s greedy steps of
    ``prompt`` into ``tokens`` on the card (model.forward over the
    sequence): the logit gap (within the routed candidates on a screened
    head) and, on a screened head, the cluster-score gap; the smaller of
    the two per step."""
    from repro_torch.core.screening import screened_topk
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]])[None],
                          device="cuda")
    with torch.inference_mode():
        h, _ = model.forward(params, {"tokens": seq})
        h = h[0, len(prompt) - 1:].contiguous()
        if head == "exact":
            top = model.logits(params, h).topk(2, dim=-1).values
            return (top[:, 0] - top[:, 1]).cpu().numpy()
        W, b = model.softmax_weights(params)
        _, vals = screened_topk(W, b, screen, h, 2)
        sc = (h @ screen.v.T).topk(2, dim=-1).values
        return torch.minimum(vals[:, 0] - vals[:, 1],
                             sc[:, 0] - sc[:, 1]).cpu().numpy()


def gap_rule(torch, np, tag, model, params, screen, prompt, got, want, head):
    """``got`` == ``want`` (solo generate's tokens), or they first differ
    after a step whose deciding top-2 gap is below GAP. → 1 for such an
    exception, else 0; fails otherwise."""
    check(len(got) == len(want), f"{tag}: {len(got)} tokens, want "
          f"{len(want)}")
    bad = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if not bad.size:
        return 0
    t = int(bad[0])
    gaps = gap_steps(torch, np, model, params, screen, prompt, want, head)
    check(gaps[t] < GAP, f"{tag}: differs from solo generate at step {t} "
          f"with a top-2 gap {gaps[t]:.3g} >= {GAP}")
    return 1


def drive_stream(stream, reqs, plan, injector=None):
    """Join ``reqs[i]`` at tick ``plan[i]`` (or the first tick after with a
    free slot), step every tick; a step the guard refuses is stepped again.
    → ({request index: tokens}, ticks, faults, host seconds per step)."""
    from repro_torch.serving import HeadFault
    stream.fault_injector = injector
    waiting = sorted(range(len(reqs)), key=lambda i: (plan[i], i))
    done, faults, tick, step_s = {}, 0, 0, []
    while waiting or stream.n_active:
        while waiting and plan[waiting[0]] <= tick and stream.free_slots:
            i = waiting.pop(0)
            stream.join(reqs[i], tag=i)
        t0 = time.perf_counter()
        try:
            out = stream.step()
        except HeadFault:
            faults += 1
            continue
        step_s.append(time.perf_counter() - t0)
        done.update({i: toks for i, _, toks in out + stream.pop_finished()})
        tick += 1
    return done, tick, faults, step_s


def phase_stream_lstm(torch, np, ctx):
    """[stream] on full-width nmt-deen-lstm with the LM trained and the
    screen fitted in [l2s]: one screened-cuda stream of width 8, 12 joins
    over 15 ticks (prompts of 8 and 12 tokens, 4 to 24 new): tokens ==
    solo generate under the gap rule, a re-run bit-identical, one graph;
    a width-1 sampled stream == solo sampled generate bit for bit.
    → (the engine, launches of the first run)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    rng = np.random.default_rng(18)
    plan = [0, 0, 1, 3, 3, 5, 6, 8, 9, 11, 12, 14]
    reqs = [ServeRequest(prompt=rng.integers(0, V, 8 if i % 2 else 12),
                         max_new=4 + (i * 5) % 21) for i in range(len(plan))]
    head = "screened-cuda"
    ops.reset_launches()
    got, ticks, _, step_s = drive_stream(
        eng.open_stream(head, width=LSTM_W), reqs, plan)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    check(counts == {(head, "greedy"): 1}, f"[stream] graphs {counts}, "
          f"expected one (screened-cuda, greedy) at width {LSTM_W}")
    check(launches["cluster_route"] > 0 and
          launches["fused_screened_topk"] > 0,
          f"[stream] a kernel never launched: {launches}")
    again, _, _, _ = drive_stream(eng.open_stream(head, width=LSTM_W), reqs,
                                  plan)
    check(set(again) == set(got) and all(np.array_equal(again[i], got[i])
                                         for i in got),
          "[stream] a re-run of the same joins changed a token")
    check(eng.compiled_step_counts() == counts,
          "[stream] the re-run added a graph")
    near = sum(gap_rule(torch, np, f"[stream] request {i}", model, params,
                        screen, r.prompt, got[i],
                        eng.generate(r.prompt[None], r.max_new,
                                     head=head).tokens[0], head)
               for i, r in enumerate(reqs))
    req = ServeRequest(prompt=reqs[0].prompt, max_new=16, temperature=0.9,
                       top_p=0.95, seed=23)
    s = eng.open_stream(head, width=1, temperature=0.9, top_p=0.95, seed=23)
    sampled, _, _, _ = drive_stream(s, [req], [0])
    solo = eng.generate(req.prompt[None], 16, head=head, temperature=0.9,
                        top_p=0.95, seed=23).tokens[0]
    check(np.array_equal(sampled[0], solo),
          "[stream] width-1 sampled stream != solo sampled generate")
    log(f"[stream] nmt-deen-lstm (trained, fitted screen): one {head} stream "
        f"of width {LSTM_W}, {len(reqs)} joins at ticks {plan}, {ticks} "
        f"ticks; tokens == solo generate except {near} request(s) that "
        f"first differ after a step with a top-2 gap < {GAP}; a re-run is "
        f"bit-identical and adds no graph (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in counts.items()} }); width-1 "
        f"sampled (T=0.9, top-p 0.95) == solo sampled generate; host time "
        f"per stream step (replay, guard sync) median "
        f"{statistics.median(step_s) * 1e3:.4f} ms (host clock, information "
        f"only); launches: {json.dumps(launches)}")
    return eng, launches


def sched_traffic(np, rng):
    """[sched]'s 48 requests: tiers round-robin, prompts of 8 and 12
    tokens, 4 to 24 new, every fourth sampled (T = 0.9, top-p 0.95, one
    seed, so one sampled lane per head)."""
    from repro_torch.serving import ServeRequest
    tiers = ("realtime", "standard", "batch")
    return [ServeRequest(prompt=rng.integers(0, V, 8 if i % 2 else 12),
                         max_new=4 + (i * 5) % 21, latency_tier=tiers[i % 3],
                         temperature=0.9 if i % 4 == 3 else None,
                         top_p=0.95 if i % 4 == 3 else 1.0, seed=31)
            for i in range(SCHED_N)]


def run_sched(eng, reqs, policy, admission=None, per_tick=2, **kw):
    """A fresh ContinuousScheduler (max_slots 8, max_streams 4, a
    LogicalClock) fed ``per_tick`` requests a tick, then drained.
    → (results, scheduler, host seconds)."""
    from repro_torch.serving import ContinuousScheduler, LogicalClock
    sched = ContinuousScheduler(eng, policy=policy, admission=admission,
                                max_slots=LSTM_W, max_streams=4,
                                clock=LogicalClock(0.0, dt_per_read=1e-4),
                                **kw)
    t0 = time.perf_counter()
    for i in range(0, len(reqs), per_tick):
        for r in reqs[i:i + per_tick]:
            sched.submit(r)
        sched.step()
    out = sched.drain(max_ticks=5000)
    return out, sched, time.perf_counter() - t0


def phase_sched(torch, np, eng, ctx):
    """[sched] on [stream]'s engine: ContinuousScheduler over 48 requests
    (TierPolicy realtime -> screened-cuda, standard -> unfused, the rest
    exact; BudgetAdmission at 4x the largest flops_per_query; a quarter
    sampled), a second identical run (no graph added, bit-identical), a
    profiled run (device calls == counted launches, idle share), then the
    fault runs: two transient step faults retried bit for bit, and a
    permanent fault tripping the breaker to exact. → launches of the first
    run."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (BudgetAdmission, CircuitBreaker,
                                     FaultInjector, LogicalClock,
                                     ServeRequest, ServeResult, StaticPolicy,
                                     TierPolicy)
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    pol = TierPolicy({"realtime": "screened-cuda", "standard": UNFUSED},
                     default="exact")
    cat = eng.head_catalog(pol.candidates)
    budget = 4.0 * max(m["flops_per_query"] for m in cat.values())
    reqs = sched_traffic(np, np.random.default_rng(48))

    def admission():
        return BudgetAdmission(flops_budget=budget)

    torch.cuda.synchronize()
    ops.reset_launches()
    first, sched, wall = run_sched(eng, reqs, pol, admission())
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[sched] a kernel never launched: {launches}")
    again, _, wall2 = run_sched(eng, reqs, pol, admission())
    check(eng.compiled_step_counts() == counts,
          f"[sched] the second drain added graphs: {counts} -> "
          f"{eng.compiled_step_counts()}")
    same = [type(a) is type(b) and a.head == b.head and
            (a.tokens is None) == (b.tokens is None) and
            (a.tokens is None or np.array_equal(a.tokens, b.tokens))
            for a, b in zip(first, again)]
    check(len(first) == len(again) == SCHED_N and all(same),
          "[sched] the second drain's results differ from the first's")
    done = [(r, res) for r, res in zip(reqs, first)
            if isinstance(res, ServeResult)]
    check(len(done) >= SCHED_N // 4, f"[sched] only {len(done)} of "
          f"{SCHED_N} requests completed")
    near = 0
    for i, (r, res) in enumerate(done):
        check(len(res.tokens) == r.max_new and res.tokens.max() < V,
              f"[sched] request {i}: bad tokens")
        if not r.sampled:
            solo = eng.generate(r.prompt[None], r.max_new,
                                head=res.head).tokens[0]
            near += gap_rule(torch, np, f"[sched] request {i} on {res.head}",
                             model, params, screen, r.prompt, res.tokens,
                             solo, "exact" if res.head == "exact"
                             else "screened")
    snap = sched.stats.snapshot()
    tokens = sum(len(res.tokens) for _, res in done)
    busy, idle, ours, n_kern = device_profile(
        torch, "[sched] drain", lambda: run_sched(eng, reqs, pol,
                                                  admission()), wall2)

    # fault runs on the greedy traffic, all submitted at once, AcceptAll
    greedy = [r for r in reqs if not r.sampled][:16]
    clean, _, _ = run_sched(eng, greedy, pol, per_tick=len(greedy))
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", head="screened-cuda", count=2)
    retried, rs, _ = run_sched(
        eng, greedy, pol, per_tick=len(greedy), fault_injector=inj,
        max_retries=3, breaker=CircuitBreaker(failure_threshold=5,
                                              clock=LogicalClock()))
    rz = rs.stats.snapshot()["resilience"]
    check(rz["retries"] == 2 and rz["faults_transient"] == 2 and
          all(isinstance(a, ServeResult) and a.head == b.head and
              np.array_equal(a.tokens, b.tokens)
              for a, b in zip(clean, retried)),
          f"[sched] 2 transient faults: retries {rz['retries']}, results "
          f"not bit-identical to the fault-free drain")
    few = [ServeRequest(prompt=r.prompt, max_new=r.max_new)
           for r in greedy[:6]]
    inj = FaultInjector(seed=0)
    inj.arm("step", "permanent", head="screened-cuda", count=1)
    br = CircuitBreaker(failure_threshold=3, cooldown_s=1e9,
                        clock=LogicalClock())
    fell, fs, _ = run_sched(eng, few, StaticPolicy("screened-cuda"),
                            per_tick=len(few), fault_injector=inj,
                            breaker=br)
    check(br.state("screened-cuda") == "open" and
          all(isinstance(r, ServeResult) and r.head == "exact" for r in fell),
          f"[sched] permanent fault: breaker {br.state('screened-cuda')}, "
          f"heads {[getattr(r, 'head', None) for r in fell]}")
    for r, res in zip(few, fell):
        near += gap_rule(torch, np, "[sched] fallback", model, params, screen,
                         r.prompt, res.tokens,
                         eng.generate(r.prompt[None], r.max_new,
                                      head="exact").tokens[0], "exact")
    log(f"[sched] nmt-deen-lstm: ContinuousScheduler(max_slots={LSTM_W}, "
        f"max_streams=4, LogicalClock) over {SCHED_N} requests (2 a tick; "
        f"realtime -> screened-cuda, standard -> {UNFUSED}, else exact; "
        f"BudgetAdmission at 4x {max(m['flops_per_query'] for m in cat.values()):.4g}"
        f" flops; {sum(r.sampled for r in reqs)} sampled, T=0.9 top-p "
        f"0.95): admitted {snap['admitted']}, rejected {snap['rejected']}, "
        f"downgraded {snap['downgraded']}, preempted {snap['preempted']}, "
        f"completed {snap['completed']} on "
        f"{ {h: d['requests'] for h, d in snap['per_head'].items()} }; "
        f"latency p50 {snap['latency']['p50_s']:.4f} / p95 "
        f"{snap['latency']['p95_s']:.4f} logical s; {snap['ticks']} ticks")
    log(f"[sched] greedy results == solo generate except {near} that first "
        f"differ after a step with a top-2 gap < {GAP}; a second identical "
        f"drain adds no graph (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }) and "
        f"gives the same results bit for bit; launches (first drain, from "
        f"zero): {json.dumps(launches)}")
    log(f"[sched] host clock (information only): first drain {wall:.3f} s "
        f"(captures included), second {wall2:.3f} s = {tokens / wall2:.1f} "
        f"tok/s, {wall2 / snap['ticks'] * 1e3:.4f} ms a tick; profile of a "
        f"third: device busy {busy:.3f} ms of {wall2 * 1e3:.3f} ms (idle "
        f"share {idle:.3f}), {n_kern} device kernels; per launch: " +
        "; ".join(f"{k} {ms / n * 1e3:.2f} us x{n}"
                  for k, (ms, n) in ours.items()))
    log(f"[sched] faults: 2 transient step faults on screened-cuda retried "
        f"(retries {rz['retries']}), results bit-identical to the fault-free "
        f"drain of the same {len(greedy)} greedy requests; a permanent fault "
        f"tripped the breaker ({fs.stats.snapshot()['resilience']['breaker_trips']}"
        f" trip) and {len(fell)} requests fell back to exact")
    return launches


def phase_stream_hybrid(torch, np, ctx):
    """[stream] on full-width float32 zamba2-2.7b: one screened-cuda stream
    of width 4, prompts of 512, 384, 256 and 100 tokens joining at ticks 0,
    3, 7 and 12, 32 new each: tokens == solo generate under the gap rule;
    one transient fault after every row joined gives the fault-free tokens
    and cache (K/V, SSM states, conv tails) bit for bit; 9 cache launches
    a step; the snapshot's and the join splice's times. → launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine, FaultInjector, ServeRequest
    from repro_torch.serving.engine import _recurrent_leaves, _splice_cache
    from repro_torch.tree import tree_leaves
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    cfg = model.cfg
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda")
    rng = np.random.default_rng(19)
    lens, plan = (512, 384, 256, 100), [0, 3, 7, 12]
    reqs = [ServeRequest(prompt=rng.integers(0, ZV, n), max_new=ZNEW)
            for n in lens]
    head = "screened-cuda"
    # the one stream slab of the width, held here so that its cache can be
    # read after each run (both runs' streams are lent it)
    slab = eng._lend_stream_slab(ZSTREAM_W, eng._token_step_key(
        eng.resolve_head(head), None, 1.0))
    eng._return_stream_slab(slab)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got, ticks, _, step_s = drive_stream(
        eng.open_stream(head, width=ZSTREAM_W), reqs, plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    clean = [x.clone() for x in tree_leaves(slab.cache)]
    check(launches["ssd_intra"] == cfg.num_layers * len(reqs),
          f"[stream] zamba2: ssd_intra launched {launches['ssd_intra']}, "
          f"expected {cfg.num_layers} per join")
    check(launches["cache_slot_update"] == n_attn * ticks,
          f"[stream] zamba2: cache_slot_update launched "
          f"{launches['cache_slot_update']}, expected {n_attn} x {ticks} "
          f"steps")
    check(launches["cluster_route"] > 0 and
          launches["fused_screened_topk"] > 0,
          f"[stream] zamba2: a kernel never launched: {launches}")
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", count=1, after=plan[-1] + 1)
    retried, _, faults, _ = drive_stream(
        eng.open_stream(head, width=ZSTREAM_W), reqs, plan, injector=inj)
    check(faults == 1 and all(np.array_equal(retried[i], got[i])
                              for i in got),
          f"[stream] zamba2: {faults} faults; the retried run's tokens differ")
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(slab.cache),
                                              clean)]
    check(all(same), f"[stream] zamba2: the retried run's cache differs "
          f"from the fault-free run's in {same.count(False)} leaves")
    del clean
    near = sum(gap_rule(torch, np, f"[stream] zamba2 request {i}", model,
                        params, screen, r.prompt, got[i],
                        eng.generate(r.prompt[None], r.max_new,
                                     head=head).tokens[0], head)
               for i, r in enumerate(reqs))

    def event_ms(fn, n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    with torch.inference_mode():
        save_ms = event_ms(slab.save, 20)
        solo, _ = eng._prefill(reqs[0].prompt[None], ZNEW)
        splice_ms = event_ms(lambda: _splice_cache(slab.cache, solo.cache, 1,
                                                   cfg), 20)
        t0 = time.perf_counter()
        s = eng.open_stream(head, width=ZSTREAM_W)
        s.join(reqs[0])
        torch.cuda.synchronize()
        join_s = time.perf_counter() - t0
        s.evict(0)
    saved = sum(x.numel() * x.element_size()
                for x in _recurrent_leaves(slab.cache))
    row = sum(x.select(0 if cfg.family == "lstm" else 1, 0).numel() *
              x.element_size() for x in tree_leaves(slab.cache))
    log(f"[stream] zamba2-2.7b: one {head} stream of width {ZSTREAM_W}, "
        f"prompts {lens} joining at ticks {plan}, {ZNEW} new each, "
        f"{ticks} ticks: tokens == solo generate except {near} request(s) "
        f"that first differ after a step with a top-2 gap < {GAP}; one "
        f"transient fault after every row joined: tokens and all "
        f"{len(same)} cache leaves (K/V, SSM states, conv tails) "
        f"bit-identical to the fault-free run; cache_slot_update "
        f"{n_attn} a step; launches: {json.dumps(launches)}")
    log(f"[stream] zamba2-2.7b rollback snapshot: {saved / 2 ** 20:.1f} MiB "
        f"of recurrent leaves copied at the start of every step, "
        f"{save_ms:.4f} ms (CUDA events, mean of 20), "
        f"{save_ms / statistics.median(step_s[plan[-1]:]) / 1e3:.2%} of the "
        f"median host-clock stream step "
        f"{statistics.median(step_s[plan[-1]:]) * 1e3:.3f} ms; join splice "
        f"(whole rows, {row / 2 ** 20:.1f} MiB): {splice_ms:.4f} ms; a whole "
        f"join of 512 tokens (B = 1 prefill, first token, splice) "
        f"{join_s * 1e3:.1f} ms; stream run {wall:.3f} s (host clock)")
    return launches


def phase_serve_cli(torch):
    """[serve-cli] ``python -m repro_torch.launch.serve`` on the card:
    --arch nmt-deen-lstm --l2s --scheduler --log-jsonl (50 train steps, 12
    requests) returns 0 and every JSONL line parses; bad flags return 2."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve
    base = ["--arch", "nmt-deen-lstm", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ticks.jsonl"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main(base + ["--l2s", "--scheduler", "--log-jsonl",
                                    str(path), "--train-steps", "50",
                                    "--requests", "12"])
        secs = time.perf_counter() - t0
        lines = path.read_text().splitlines()
        recs = [json.loads(ln) for ln in lines]
    check(rc == 0, f"[serve-cli] exit code {rc}:\n{out.getvalue()}")
    check(recs and all("tick" in r and "delta" in r for r in recs),
          "[serve-cli] a JSONL record lacks tick / delta")
    spec_argv = ["--l2s", "--scheduler", "--draft-head", "screened-cuda",
                 "--budget", "1024", "--train-steps", "20", "--requests",
                 "8", "--max-new", "16"]
    spec_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(spec_out):
        spec_rc = serve.main(base + spec_argv)
    spec_secs = time.perf_counter() - t0
    check(spec_rc == 0 and "spec[screened-cuda]" in spec_out.getvalue(),
          f"[serve-cli] --draft-head screened-cuda: exit code {spec_rc}:\n"
          f"{spec_out.getvalue()}")
    bad = {"--head screened without --l2s": ["--head", "screened"],
           "--log-jsonl without --scheduler": ["--log-jsonl", "x.jsonl"],
           "--draft-head exact": ["--scheduler", "--draft-head", "exact"],
           "--draft-head without --scheduler": ["--draft-head", "screened",
                                                "--l2s"]}
    codes = {}
    for name, argv in bad.items():
        with contextlib.redirect_stdout(io.StringIO()):
            codes[name] = serve.main(base + argv)
    check(all(c == 2 for c in codes.values()), f"[serve-cli] bad flags "
          f"returned {codes}")
    for ln in out.getvalue().splitlines() + spec_out.getvalue().splitlines():
        log(ln)
    log(f"[serve-cli] python -m repro_torch.launch.serve {' '.join(base)} "
        f"--l2s --scheduler --log-jsonl ... --train-steps 50 --requests 12: "
        f"exit 0 in {secs:.1f} s, {len(recs)} JSONL tick records parse; "
        f"{' '.join(spec_argv)}: exit 0 in {spec_secs:.1f} s; bad flags "
        f"exit {codes}")


def cli_zamba2(torch):
    """[serve-cli] the launchers on full-width zamba2-2.7b (float32, drawn
    from a CPU generator as the launchers draw): ``launch.train`` 2 steps
    of 4 x 512 saving a checkpoint (params and AdamW state, 27.8 GB), then
    run again with the same ``--steps``: it resumes from the checkpoint and
    has nothing left to train or save (a second checkpoint would pass the
    chip machine's 45 GiB limit on disk writes);
    ``launch.serve --l2s --head screened-cuda`` (train, fit a block
    screen, serve) exits 0 with its token-agreement line."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve, train
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as ck:
        targv = ["--arch", "zamba2-2.7b", "--device", "cuda", "--batch", "4",
                 "--seq", "512", "--log-every", "1", "--ckpt-dir", ck]
        for run in ("first", "resumed"):
            out = io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = train.main(targv + ["--steps", "2"])
            runs[run] = (rc, out.getvalue(), time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
            gc.collect()
            torch.cuda.empty_cache()
    first, resumed = runs["first"], runs["resumed"]
    check(first[0] == 0 and first[1].count("[train] step") == 2 and
          "saved checkpoint at step 2" in first[1],
          f"[serve-cli] launch.train zamba2-2.7b: exit {first[0]}:\n{first[1]}")
    check(resumed[0] == 0 and "resumed from step 2" in resumed[1] and
          "[train] step" not in resumed[1] and "saved" not in resumed[1],
          f"[serve-cli] launch.train zamba2-2.7b resume: exit {resumed[0]}:"
          f"\n{resumed[1]}")
    for ln in first[1].splitlines() + resumed[1].splitlines():
        log(ln)
    log(f"[serve-cli] python -m repro_torch.launch.train {' '.join(targv[:-1])}"
        f" <dir> --steps 2: exit 0 in {first[2]:.1f} s (peak device memory "
        f"{first[3]:.2f} GiB, remat none); the same again resumed from its "
        f"checkpoint: exit 0 in {resumed[2]:.1f} s (peak {resumed[3]:.2f} GiB)")
    sargv = ["--arch", "zamba2-2.7b", "--device", "cuda", "--l2s", "--head",
             "screened-cuda", "--budget", "1024", "--train-steps", "2",
             "--requests", "4", "--max-new", "8"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(sargv)
    secs = time.perf_counter() - t0
    check(rc == 0 and "screened-cuda decode:" in out.getvalue() and
          "token agreement" in out.getvalue(),
          f"[serve-cli] launch.serve zamba2-2.7b: exit {rc}:\n{out.getvalue()}")
    for ln in out.getvalue().splitlines():
        log(ln)
    log(f"[serve-cli] python -m repro_torch.launch.serve {' '.join(sargv)}: "
        f"exit 0 in {secs:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


# -- speculative decoding and the page pool -------------------------------------
SPEC_N = 4                       # [spec] draft length (n_max)
POOL_PAGE = 16                   # [pool] page size


def counted(torch, acc, fn):
    """Run ``fn`` with the launch counters from zero and add its launches to
    ``acc``: a path's counts gather its own runs only, never the check
    runs between them. → fn's result."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, n in ops.LAUNCHES.items():
        acc[k] = acc.get(k, 0) + n
    return out


def spec_summary(s, step_s):
    """A spec stream's acceptance, emitted tokens per round (per slot) and
    median host time per round."""
    c = s.spec_counters()
    return (f"acceptance {c['accepted'] / max(c['drafted'], 1):.4f} "
            f"({c['accepted']}/{c['drafted']} drafts), "
            f"{c['emitted'] / max(c['rounds'], 1):.4f} emitted per round "
            f"({c['emitted']} in {c['rounds']} slot rounds, "
            f"{c['draft_steps']} draft steps), "
            f"{s.restored_rows} rows restored from the ring, host time per "
            f"round median {statistics.median(step_s) * 1e3:.4f} ms (host "
            f"clock, information only)")


def random_lstm_screen(np):
    """[e2e]'s random screen (r = 100, K = 16 over 196 tiles)."""
    from repro_torch.interop import screen_from_numpy
    rng = np.random.default_rng(0)
    n_blk = -(-V // V_BLK)
    v = rng.standard_normal((R, D)).astype(np.float32)
    cand = make_screen_blocks(np, 6, n_blk)
    return screen_from_numpy(v, cand, (cand < n_blk).sum(1), V, V_BLK)


def check_dist_logits(torch, np, eng, tag):
    """``screened-cuda.dist_logits`` on the card against its plain version
    (the head on CPU copies): values within TOL, the same finite support,
    equal to the routed cluster's candidate words < V (rows whose top-2
    cluster scores differ by < 1e-5 relative aside), every sampled id
    inside it (fused, and top-p 0.9 through the gather). → rows checked."""
    from repro_torch.heads import ScreenedCudaHead
    from repro_torch.heads.base import NEG_INF
    from repro_torch.kernels.route import cluster_route
    hd = eng.resolve_head("screened-cuda")
    scr = eng.screen
    g = torch.Generator(device="cuda").manual_seed(12)
    h = torch.randn((SPEC_N * LSTM_W, D), generator=g, device="cuda")
    with torch.inference_mode():
        got = hd.dist_logits(h)
        plain = ScreenedCudaHead(eng.W.cpu(), eng.b.cpu(),
                                 scr.to("cpu")).dist_logits(h.cpu())
        scores = (h.cpu() @ scr.v.cpu().T).double()
        top = scores.topk(2, dim=-1).values
        tie = ((top[:, 0] - top[:, 1]) <
               1e-5 * top[:, 0].abs().clamp(min=1.0)).numpy()
        on, pon = got > NEG_INF / 2, plain > NEG_INF / 2
        keep = torch.as_tensor(~tie)
        check(torch.equal(on.cpu()[keep], pon[keep]),
              f"{tag}: dist_logits support differs from its plain version")
        err = float((torch.where(on, got, 0.0).cpu() -
                     torch.where(pon, plain, 0.0))[keep].abs().max())
        check(torch.allclose(torch.where(on, got, 0.0).cpu()[keep],
                             torch.where(pon, plain, 0.0)[keep], **TOL),
              f"{tag}: dist_logits differ from the plain version by {err}")
        cluster = cluster_route(h, scr.v).long()
        blocks = scr.cand_idx[cluster]                      # (B, K)
        n_blk = -(-V // V_BLK)
        lane = torch.arange(V_BLK, device="cuda")
        wid = (blocks[..., None].long() * V_BLK + lane).reshape(len(h), -1)
        ok = ((blocks < n_blk)[..., None].expand(-1, -1, V_BLK)
              .reshape(len(h), -1)) & (wid < V)
        dump = n_blk * V_BLK                 # sentinel slots land past V
        words = torch.zeros((len(h), dump + 1), dtype=torch.bool,
                            device="cuda")
        words.scatter_(1, torch.where(ok, wid, dump), True)
        words = words[:, :V]
        check(torch.equal(on, words), f"{tag}: the finite support is not "
              f"the routed candidate words < V")
        rows = torch.arange(len(h), device="cuda")
        for top_p in (1.0, 0.9):
            for _ in range(25):
                ids = hd.sample(h, 1.0, top_p, generator=g).long()
                check(bool(on[rows, ids].all()), f"{tag}: a sampled id lies "
                      f"outside dist_logits' support (top-p {top_p})")
    log(f"{tag} screened-cuda dist_logits on {len(h)} rows (route + gather "
        f"kernels, scattered to V = {V}): == its plain version (max |diff| "
        f"{err:.3g}, rtol = atol = 1e-5; {int(tie.sum())} rows with a route "
        f"tie aside), finite support == the routed candidate words < V "
        f"({int(on.sum())} words), 2 x 25 sampled draws (fused; top-p 0.9) "
        f"inside it")
    return err


def phase_spec_lstm(torch, np, ctx):
    """[spec] on the trained nmt-deen-lstm and its fitted screen: a width-8
    SpecDecodeStream (draft screened-cuda, verify exact, draft_len 4), 12
    joins: greedy tokens == a plain width-8 exact stream under the gap
    rule; a second stream adds no graph and repeats bit for bit; the random
    [e2e] screen as the draft (rejections > 0); a sampled stream (T = 1)
    twice from one seed, bit-identical; dist_logits on the card; a
    profiled round. → (launches of the path's runs, dist_logits error)."""
    from repro_torch.heads import ScreenedCudaHead
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    rng = np.random.default_rng(20)
    plan = [0, 0, 1, 3, 3, 5, 6, 8, 9, 11, 12, 14]
    reqs = [ServeRequest(prompt=rng.integers(0, V, 8 if i % 2 else 12),
                         max_new=4 + (i * 5) % 21) for i in range(len(plan))]
    plain, _, _, plain_s = drive_stream(eng.open_stream("exact",
                                                        width=LSTM_W),
                                        reqs, plan)
    acc = {}

    def run(draft, **kw):
        s = eng.open_spec_stream(draft, "exact", width=LSTM_W,
                                 draft_len=SPEC_N, **kw)
        got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
            s, reqs, plan))
        return s, got, step_s

    def held(tag, got):
        return sum(gap_rule(torch, np, f"{tag} request {i}", model, params,
                            screen, r.prompt, got[i], plain[i], "exact")
                   for i, r in enumerate(reqs))

    s1, got, step1 = run("screened-cuda")
    near = held("[spec] fitted", got)
    counts = eng.compiled_step_counts()
    check(counts.get(("exact", "spec-verify")) == 1 and
          counts.get(("screened-cuda", "greedy")) == 1,
          f"[spec] graphs {counts}")
    s2, again, _ = run("screened-cuda")
    check(eng.compiled_step_counts() == counts and
          all(np.array_equal(again[i], got[i]) for i in got),
          "[spec] a second stream of the same shape added a graph or "
          "changed a token")
    rand = ScreenedCudaHead(eng.W, eng.b,
                            random_lstm_screen(np).to("cuda")).prepare()
    s3, rgot, step3 = run(rand)
    near_r = held("[spec] random draft", rgot)
    c3 = s3.spec_counters()
    check(c3["drafted"] - c3["accepted"] > 0 and s3.restored_rows > 0,
          f"[spec] the random draft was never rejected: {c3}")
    samp = [run("screened-cuda", temperature=1.0, seed=7) for _ in range(2)]
    check(all(np.array_equal(samp[0][1][i], samp[1][1][i]) and
              samp[0][1][i].max() < V for i in samp[0][1]),
          "[spec] two sampled runs from one seed differ")
    counts = eng.compiled_step_counts()
    err = check_dist_logits(torch, np, eng, "[spec]")
    few = reqs[:4]
    profile_counted(torch, "[spec] round", lambda: drive_stream(
        eng.open_spec_stream(rand, "exact", width=LSTM_W, draft_len=SPEC_N),
        few, [0] * len(few)))
    log(f"[spec] nmt-deen-lstm (trained, fitted screen): SpecDecodeStream "
        f"width {LSTM_W}, draft screened-cuda, verify exact, draft_len "
        f"{SPEC_N}, {len(reqs)} joins at ticks {plan}: greedy tokens == a "
        f"plain width-{LSTM_W} exact stream except {near} request(s) that "
        f"first differ after a step with a top-2 gap < {GAP}; "
        f"{spec_summary(s1, step1)}; plain exact stream host time per step "
        f"median {statistics.median(plain_s) * 1e3:.4f} ms; a second stream "
        f"adds no graph and repeats bit for bit (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} })")
    log(f"[spec] the random [e2e] screen as the draft: tokens == the plain "
        f"exact stream except {near_r} near tie(s); {spec_summary(s3, step3)}"
        f"; live draft length at the end {s3.controller.n}")
    log(f"[spec] sampled (T = 1, seed 7) twice: bit-identical; "
        f"{spec_summary(samp[0][0], samp[0][2])}")
    log(f"[spec] launches of the path's own runs (5 streams, from zero): "
        f"{json.dumps(acc)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return acc, err


def pool_traffic(np):
    """[pool]'s 16 requests: 2 prompts of 48 tokens, each with distinct
    suffixes of 4-20 tokens, 12-20 new."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(21)
    bases = rng.integers(0, V, (2, 48))
    return [ServeRequest(prompt=np.concatenate(
        [bases[i % 2], rng.integers(0, V, 4 + (i * 7) % 17)]),
        max_new=12 + (i * 3) % 9) for i in range(16)]


def phase_pool_lstm(torch, np, ctx):
    """[pool] on the same LM: a width-8 PagedDecodeStream (page 16) over
    16 requests sharing 2 prompts == a plain width-8 stream bit for bit,
    radix hits and prefill tokens skipped; a ContinuousScheduler drain on a
    pool too small for the traffic (PoolExhausted, preemption, every
    request ends with a result, completed ones bit-identical); a drain
    with kv_pool= and spec=SpecPolicy() == the same drain without them
    (gap rule), its ServerStats pool and spec fields. → launches of the
    path's runs."""
    from repro_torch.serving import (ContinuousScheduler, DecodeEngine,
                                     PagePool, ServeResult, SpecPolicy,
                                     StaticPolicy)
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    reqs = pool_traffic(np)
    plan = [0] * len(reqs)
    head = "screened-cuda"
    plain, _, _, _ = drive_stream(eng.open_stream(head, width=LSTM_W), reqs,
                                  plan)
    acc = {}
    pool = PagePool(256, POOL_PAGE)
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        eng.open_paged_stream(pool, head=head, width=LSTM_W), reqs, plan))
    check(all(np.array_equal(got[i], plain[i]) for i in plain),
          "[pool] paged tokens differ from the plain stream's")
    rx = pool.radix.telemetry()
    check(rx["tokens_hit"] > 0, f"[pool] no radix hit: {rx}")
    log(f"[pool] nmt-deen-lstm: PagedDecodeStream width {LSTM_W}, page "
        f"{POOL_PAGE}, {len(reqs)} requests on 2 shared prompts of 48 "
        f"tokens (+ 4-20 distinct): tokens == a plain width-{LSTM_W} "
        f"{head} stream bit for bit; radix lookups {rx['lookups']}, hits "
        f"{rx['lookup_hits']}, prefill tokens skipped {rx['tokens_hit']} of "
        f"{rx['tokens_total']} (hit rate {rx['hit_rate']:.4f}), nodes "
        f"{rx['nodes']}, COW copies {pool.cow_copies}, pages in use "
        f"{pool.pages_in_use} (peak {pool.peak_in_use}); host time per step "
        f"median {statistics.median(step_s) * 1e3:.4f} ms (host clock)")

    small = PagePool(14, POOL_PAGE)                # 13 pages for 16 requests
    out, sched, _ = counted(torch, acc, lambda: run_sched(
        eng, reqs, StaticPolicy(head), per_tick=len(reqs), kv_pool=small))
    snap = sched.stats.snapshot()
    done = [i for i, r in enumerate(out) if isinstance(r, ServeResult)]
    check(len(out) == len(reqs) and snap["pool"]["stalled_ticks"] > 0 and
          snap["preempted"] > 0 and done,
          f"[pool] the small pool's drain: {len(out)} results, stalled "
          f"{snap['pool']['stalled_ticks']} ticks, preempted "
          f"{snap['preempted']}, {len(done)} completed")
    check(all(np.array_equal(out[i].tokens, plain[i]) for i in done),
          "[pool] a completed request of the small pool's drain differs")
    log(f"[pool] ContinuousScheduler(max_slots={LSTM_W}, kv_pool="
        f"PagePool(14, {POOL_PAGE})) over the {len(reqs)} requests at once: "
        f"PoolExhausted stalled {snap['pool']['stalled_ticks']} ticks, "
        f"preempted {snap['preempted']}, completed {len(done)} (== the plain "
        f"stream bit for bit), every request ended with a result in "
        f"{snap['ticks']} ticks; pool {json.dumps(snap['pool'])}")

    plain_sched, _, _ = run_sched(eng, reqs, StaticPolicy("exact"),
                                  per_tick=len(reqs))
    big = PagePool(512, POOL_PAGE)
    spec_out, ss, wall = counted(torch, acc, lambda: run_sched(
        eng, reqs, StaticPolicy("exact"), per_tick=len(reqs), kv_pool=big,
        spec=SpecPolicy()))
    near = 0
    for i, (a, b) in enumerate(zip(spec_out, plain_sched)):
        check(isinstance(a, ServeResult) and isinstance(b, ServeResult) and
              a.head == "exact+spec[screened-cuda]",
              f"[pool] request {i}: {type(a).__name__} on "
              f"{getattr(a, 'head', None)}")
        near += gap_rule(torch, np, f"[pool] spec+pool request {i}", model,
                         params, screen, reqs[i].prompt, a.tokens, b.tokens,
                         "exact")
    snap = ss.stats.snapshot()
    log(f"[pool] ContinuousScheduler(kv_pool=PagePool(512, {POOL_PAGE}), "
        f"spec=SpecPolicy()) == the same drain without them except {near} "
        f"request(s) after a top-2 gap < {GAP}; {wall:.3f} s host clock; "
        f"spec {json.dumps(snap['spec'])}; pool {json.dumps(snap['pool'])}")
    log(f"[pool] launches of the path's own runs (from zero): "
        f"{json.dumps(acc)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return acc


def phase_spec_hybrid(torch, np, ctx):
    """[spec] on full-width float32 zamba2-2.7b: a width-4 spec stream
    (draft screened-cuda on the random screen, verify exact, draft_len 4),
    4 prompts of 512, 32 new: tokens == a plain width-4 exact stream under
    the gap rule, rejections > 0; the snapshot ring's bytes and copy time.
    → launches of the path's run."""
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda")
    rng = np.random.default_rng(22)
    reqs = [ServeRequest(prompt=rng.integers(0, ZV, 512), max_new=ZNEW)
            for _ in range(ZSTREAM_W)]
    plan = [0] * len(reqs)
    plain, _, _, plain_s = drive_stream(eng.open_stream("exact",
                                                        width=ZSTREAM_W),
                                        reqs, plan)
    acc = {}
    s = eng.open_spec_stream("screened-cuda", "exact", width=ZSTREAM_W,
                             draft_len=SPEC_N)
    t0 = time.perf_counter()
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        s, reqs, plan))
    wall = time.perf_counter() - t0
    near = sum(gap_rule(torch, np, f"[spec] zamba2 request {i}", model,
                        params, screen, r.prompt, got[i], plain[i], "exact")
               for i, r in enumerate(reqs))
    c = s.spec_counters()
    check(c["drafted"] - c["accepted"] > 0 and s.restored_rows > 0,
          f"[spec] zamba2: no draft was rejected: {c}")
    cfg = model.cfg
    check(acc["ssd_intra"] == cfg.num_layers * len(reqs),
          f"[spec] zamba2: ssd_intra launched {acc['ssd_intra']}")
    slab = eng._lend_stream_slab(ZSTREAM_W, s._slab_key(),
                                 spec_depth=SPEC_N)
    ring = slab.spec.ring_nbytes
    with torch.inference_mode():
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for j in range(20):
            slab.spec.snapshot(slab.cache, j % SPEC_N)
        b.record()
        b.synchronize()
    copy_ms = a.elapsed_time(b) / 20
    eng._return_stream_slab(slab)
    log(f"[spec] zamba2-2.7b: SpecDecodeStream width {ZSTREAM_W}, draft "
        f"screened-cuda (random screen), verify exact, draft_len {SPEC_N}, "
        f"{len(reqs)} prompts of 512, {ZNEW} new, max_len {ZMAX}: tokens == "
        f"a plain width-{ZSTREAM_W} exact stream except {near} request(s) "
        f"that first differ after a step with a top-2 gap < {GAP}; "
        f"{spec_summary(s, step_s)}; live draft length at the end "
        f"{s.controller.n}; {ticks} rounds in {wall:.3f} s against the "
        f"plain stream's {len(plain_s)} steps at median "
        f"{statistics.median(plain_s) * 1e3:.3f} ms (host clock)")
    log(f"[spec] zamba2-2.7b snapshot ring: {ring / 2 ** 20:.1f} MiB "
        f"({SPEC_N} slots of the recurrent leaves), one slot's copy "
        f"{copy_ms:.4f} ms (CUDA events, mean of 20); launches of the run "
        f"(from zero): {json.dumps(acc)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return acc


# -- the other heads: adaptive, the §4.1 baselines, host heads ---------------
SHORTLIST, N_TAILS = 2048, 4     # [heads] adaptive: 16 short tiles, 4 tails
N_BASE = 1_000                   # [heads] held-out rows for the baselines
N_SVD_FULL = 200                 # [heads] rows for full-rank svd == exact
# [heads] a layout whose rows descend: one short tile; the last k passes
# its 128 slots, so every row descends there
DESC_SHORTLIST, DESC_K = 128, (5, 64, 128, 129)
BASELINES = ("svd", "shortlist", "greedy-mips", "lsh-mips", "pca-mips",
             "screened-cpu")


def adaptive_bound(torch, hd, h, k=1):
    """Bound of one adaptive step on ``h`` (B, d) at ``k``: the short
    tiles, the distinct tail tiles the head's own rule sends the rows to
    (``tier_blocks``; each read once, bias rows included), the gates and h;
    per-row multiply-adds for the operations. → (ms, "bytes" |
    "operations")."""
    B, d = h.shape
    lay = hd.layout
    with torch.inference_mode():
        _, tail, _ = hd.tier_blocks(h, k)
        live = tail[tail < lay.n_blk]
        tiles = lay.nb0 + int(live.unique().numel())
    nbytes = 4 * (tiles * V_BLK * (d + 1) + lay.C * (d + 1) + B * d +
                  2 * B * (2 * k + 1))
    flops = 2 * d * (B * (lay.nb0 * V_BLK + lay.C) + live.numel() * V_BLK)
    return bound_ms(nbytes, flops)


def descent_check(torch, tag, fused, unfused, h, ks):
    """A tier layout whose rows descend, at each k of ``ks`` on ``h``:
    fused == unfused ids and values bit for bit, log-probs within TOL and
    never NaN; on the first 256 descending rows (the plain version gathers
    each row's tiles) the tail launch (live block ids) against
    ``fused_screened_topk_plain``, and logZ finite. → ({k: rows descending}, max abs
    error of the tail launch, ids differing at near-ties)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_screened_topk_plain
    lay = fused.layout
    down, err, near = {}, 0.0, 0
    with torch.inference_mode():
        for k in ks:
            fi, fv = fused.topk(h, k)
            ui, uv = unfused.topk(h, k)
            check(torch.equal(fi, ui) and torch.equal(fv, uv),
                  f"{tag} k={k}: fused and unfused ids or values differ")
            fl, ul = fused.topk_logprobs(h, k)[1], unfused.topk_logprobs(h, k)[1]
            check(not bool(torch.isnan(fl).any()), f"{tag} k={k}: NaN "
                  f"log-probs")
            torch.testing.assert_close(fl, ul, **TOL)
            _, tail, d = fused.tier_blocks(h, k)
            down[k] = int(d.sum())
            if not down[k]:
                continue
            hd, tb = h[d][:256].contiguous(), tail[d][:256].contiguous()
            kt = min(k, lay.kb * V_BLK)
            ti, tv, tz = ops.tier_fused_topk(fused._Wb, fused._bb, hd, tb,
                                             k=kt)
            pi, pv, pz = fused_screened_topk_plain(fused._Wb, fused._bb, hd,
                                                   tb, kt)
            torch.testing.assert_close(tv, pv, **TOL)
            torch.testing.assert_close(tz, pz, **TOL)
            check(bool(torch.isfinite(tz).all()), f"{tag} k={k}: a "
                  f"descending row's tail logZ is not finite")
            diff = ti != pi
            if bool(diff.any()):
                rel = ((tv[diff] - pv[diff]).abs() /
                       pv[diff].abs().clamp_min(1e-30))
                check(bool((rel < 1e-5).all()), f"{tag} k={k}: tail ids "
                      f"differ from the plain version beyond near-ties")
                near += int(diff.sum())
            err = max(err, float((tv - pv).abs().max()),
                      float((tz - pz).abs().max()))
    check(sum(down.values()) > 0, f"{tag}: no row descended at k in {ks}")
    return down, err, near


def screened_bound(torch, screen, h):
    """Bound of one screened-cuda step: the route's v, the distinct
    candidate tiles of the routed clusters, h."""
    B, d = h.shape
    with torch.inference_mode():
        cl = torch.argmax(h @ screen.v.T, dim=-1)
        blocks = screen.cand_idx[cl]
        n_blk = -(-screen.vocab_size // V_BLK)
        tiles = int(blocks[blocks < n_blk].unique().numel())
        per_row = int((blocks < n_blk).sum())
    nbytes = 4 * (screen.v.numel() + tiles * V_BLK * (d + 1) + B * d)
    flops = 2 * d * (B * screen.r + per_row * V_BLK)
    return bound_ms(nbytes, flops)


def time_head_steps(torch, timer, hd_by_name, W, h, screen, adaptive,
                    descent):
    """One decode step's head (``next``) of each head at ``h`` (B, d), the
    adaptive step's two fused launches alone (its tail ids by the head's
    own rule), and those of ``descent`` = (an adaptive head whose rows
    descend, its k), in turns under the clean-L2 timer → {name: (ms,
    bound)}."""
    from repro_torch.kernels import ops
    B, d = h.shape
    L = W.shape[0]

    def two_launches(ad, k):
        with torch.inference_mode():
            short, tail, _ = ad.tier_blocks(h, k)
        ks = min(k, ad.layout.nb0 * V_BLK)
        kt = min(k, ad.layout.kb * V_BLK)

        def run():
            ops.tier_fused_topk(ad._Wb, ad._bb, h, short, k=ks)
            ops.tier_fused_topk(ad._Wb, ad._bb, h, tail, k=kt)
        return run
    dh, dk = descent
    with torch.inference_mode():
        fns = {n: (lambda hd=hd: hd.next(h)) for n, hd in hd_by_name.items()}
        fns["adaptive-kernels"] = two_launches(adaptive, 1)
        fns["adaptive-descend-kernels"] = two_launches(dh, dk)
        t = timer.turns(fns)
    bounds = {"exact": bound_ms(4 * (L * (d + 1) + B * d), 2 * B * L * d),
              "screened-cuda": screened_bound(torch, screen, h),
              "adaptive": adaptive_bound(torch, adaptive, h),
              "adaptive-descend-kernels": adaptive_bound(torch, dh, h, dk)}
    bounds["adaptive-kernels"] = bounds["adaptive"]
    return {n: (t[n], bounds[n]) for n in fns}


def phase_heads(torch, np, ctx):
    """[heads] on the trained nmt-deen-lstm and fitted screen of [l2s]: the
    adaptive head (fused == unfused bit for bit on the 10,000 held-out rows,
    P@k, descent rate; shortlist = L against exact), the §4.1 baselines and
    screened-cpu on the host (P@k, flops, ms a query; full-rank svd ==
    exact), the engine through adaptive (graphs) and host heads, a stream
    through greedy-mips, and the head steps' times. → (launches of the
    engine part, counted from zero; the step times)."""
    from repro_torch import heads
    from repro_torch.core import precision_at_k
    from repro_torch.heads import AdaptiveHead
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import topk_desc
    from repro_torch.serving import DecodeEngine, ServeRequest
    from repro_torch.testing import (eager_beam_search, eager_generate,
                                     head_sampled_generate)
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    Hte, ex, counts = ctx["Hte"], ctx["exact_top5"], ctx["counts"]
    W, b = model.softmax_weights(params)
    kw = dict(W=W, b=b, counts=counts, shortlist=SHORTLIST, n_tails=N_TAILS,
              device="cuda")
    fused = heads.get("adaptive", **kw)
    unfused = heads.get("adaptive", fused=False, **kw)
    lay = fused.layout
    check((lay.nb0, lay.C, lay.kb, lay.n_blk) == (16, 4, 45, 196),
          f"[heads] adaptive layout {(lay.nb0, lay.C, lay.kb, lay.n_blk)}, "
          f"want (16, 4, 45, 196)")
    hte = torch.as_tensor(Hte, device="cuda")
    with torch.inference_mode():
        fi, fv = fused.topk(hte, 5)
        ui, uv = unfused.topk(hte, 5)
        logits = hte @ W.T + b
        top6 = topk_desc(logits, 6)[0]
        gaps = (top6[:, :-1] - top6[:, 1:]).min(dim=1).values.cpu().numpy()
    check(torch.equal(fi, ui) and torch.equal(fv, uv),
          "[heads] adaptive fused and unfused ids or values differ")
    fi = fi.cpu().numpy()
    with torch.inference_mode():
        rate = float(fused.tier_blocks(hte, 5)[2].float().mean())
    p_ad = (precision_at_k(fi[:, :1], ex[:, :1]), precision_at_k(fi, ex))
    full = heads.get("adaptive", W=W, b=b, shortlist=V, device="cuda")
    with torch.inference_mode():
        full_ids = full.topk(hte, 5)[0].cpu().numpy()
    bad = np.nonzero((full_ids != ex).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(), f"[heads] adaptive shortlist = L "
          f"differs from exact on {len(bad)} rows, some with a top-k gap >= "
          f"{TOP_GAP}")
    log(f"[heads] adaptive (counts of the training tokens, shortlist "
        f"{SHORTLIST}, {N_TAILS} tails: nb0 {lay.nb0}, tails of "
        f"{lay.tail_sizes} words, kb {lay.kb}, n_blk {lay.n_blk}) on the "
        f"{len(Hte)} held-out rows: fused == unfused ids and values bit for "
        f"bit; P@1 / P@5 against exact {p_ad[0]:.4f} / {p_ad[1]:.4f}; "
        f"descent rate at k=5 {rate:.4f} (cost model p_descend "
        f"{lay.p_descend:.4f}); flops_per_query {fused.flops_per_query:.0f} "
        f"(exact {V * D}); shortlist = L (one tier of {full._lay.nb0} "
        f"tiles) == exact except {len(bad)} rows with a top-k gap < "
        f"{TOP_GAP}")

    # a layout whose rows descend: one short tile, so the k-th short logit
    # falls below the best tail gate on some rows, and every row at k past
    # the short list's 128 slots
    dkw = dict(kw, shortlist=DESC_SHORTLIST)
    d_fused = heads.get("adaptive", **dkw)
    d_unfused = heads.get("adaptive", fused=False, **dkw)
    down, d_err, d_near = descent_check(
        torch, "[heads] adaptive descent", d_fused, d_unfused, hte, DESC_K)
    check(down[DESC_K[-1]] == len(Hte), f"[heads] adaptive descent: "
          f"{down[DESC_K[-1]]} of {len(Hte)} rows descend at k = "
          f"{DESC_K[-1]}, past the short list")
    dl = d_fused.layout
    log(f"[heads] adaptive with rows that descend (shortlist "
        f"{DESC_SHORTLIST}, {N_TAILS} tails: nb0 {dl.nb0}, kb {dl.kb}) on "
        f"the {len(Hte)} held-out rows: rows descending by k "
        f"{json.dumps(down)}; at each k fused == unfused ids and values bit "
        f"for bit, log-probs within rtol=atol=1e-5 and never NaN; the tail "
        f"launch on up to 256 descending rows a k against its plain "
        f"version max abs err {d_err:.3g} ({d_near} ids differ at "
        f"near-ties), logZ finite")

    # the baselines and screened-cpu on the host, one query at a time
    hb = torch.as_tensor(Hte[:N_BASE])               # a host tensor
    exb = ex[:N_BASE]
    rows = []
    for name in BASELINES:
        t0 = time.perf_counter()
        hd = heads.get(name, W=W, b=b, screen=screen, device="cuda")
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = hd.topk(hb, 5)[0].numpy()
        ms = (time.perf_counter() - t0) * 1e3 / N_BASE
        rows.append((name, precision_at_k(ids[:, :1], exb[:, :1]),
                     precision_at_k(ids, exb), hd.flops_per_query, ms,
                     t_build))
    svd = heads.get("svd", W=W, b=b, rho=D, n_top=V, device="cuda")
    t0 = time.perf_counter()
    svd_ids = svd.topk(hb[:N_SVD_FULL], 5)[0].numpy()
    svd_ms = (time.perf_counter() - t0) * 1e3 / N_SVD_FULL
    bad = np.nonzero((svd_ids != exb[:N_SVD_FULL]).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(), f"[heads] full-rank svd "
          f"differs from exact on {len(bad)} rows, some with a top-k gap >= "
          f"{TOP_GAP}")
    for name, p1, p5, flops, ms, tb in rows:
        log(f"[heads] {name} (host, one query at a time) on {N_BASE} held-out "
            f"rows: P@1 {p1:.4f} P@5 {p5:.4f}; flops_per_query {flops:.0f} "
            f"({V * D / flops:.1f}x fewer than exact); {ms:.4f} ms a query "
            f"(host clock); built in {tb:.2f} s")
    log(f"[heads] svd at rho = d = {D}, n_top = L on {N_SVD_FULL} of those "
        f"rows: == exact except {len(bad)} rows with a top-k gap < "
        f"{TOP_GAP}; {svd_ms:.4f} ms a query")

    # the engine: adaptive through graphs, host heads between replays
    eng = DecodeEngine(model, params, screen=screen, device="cuda",
                       head_kwargs=dict(counts=counts, shortlist=SHORTLIST,
                                        n_tails=N_TAILS))
    ad_unfused = AdaptiveHead(eng.W, eng.b, counts=counts, shortlist=SHORTLIST,
                              n_tails=N_TAILS, fused=False).prepare()
    corpus = ctx["corpus"]
    prompts = corpus.sample_batch(4, 8, seed=7)
    new = 16
    launches = {}

    def on_path(fn):
        """One of the path's own engine runs, its launches counted from zero
        and added to the path's; the runs that time, profile or check it
        against a reference are left out."""
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for name, n in ops.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n
        return out
    g_ad = on_path(lambda: eng.generate(prompts, new, head="adaptive"))
    check(ops.LAUNCHES["fused_screened_topk"] == 2 * new,
          f"[heads] adaptive greedy {len(prompts)}x{new}: fused top-k "
          f"launched {ops.LAUNCHES['fused_screened_topk']} times, want "
          f"{2 * new} (two a token)")
    _, wall = host_timed(torch, lambda: eng.generate(prompts, new,
                                                     head="adaptive"))
    ops.reset_launches()
    busy, idle, ours, n_kern = device_profile(
        torch, "[heads] adaptive greedy replay",
        lambda: eng.generate(prompts, new, head="adaptive"), wall)
    replay = dict(ops.LAUNCHES)
    check(replay["fused_screened_topk"] == 2 * new,
          f"[heads] adaptive greedy replayed: {replay}")
    ops.reset_launches()
    e_ad = eager_generate(eng, prompts, new, head="adaptive")
    check(np.array_equal(g_ad.tokens, e_ad.tokens) and
          dict(ops.LAUNCHES) == replay,
          "[heads] adaptive graph tokens or launches != the eager body's")
    g_un = eng.generate(prompts, new, head=ad_unfused)
    check(np.array_equal(g_ad.tokens, g_un.tokens),
          "[heads] adaptive fused and unfused greedy tokens differ")
    s = [on_path(lambda: eng.generate(prompts, new, head="adaptive",
                                      temperature=0.9, seed=3)),
         eng.generate(prompts, new, head="adaptive", temperature=0.9, seed=3)]
    want = head_sampled_generate(eng, prompts, new, "adaptive", 0.9, seed=3)
    check(np.array_equal(s[0].tokens, s[1].tokens) and
          np.array_equal(s[0].tokens, want),
          "[heads] adaptive sampled tokens != the head's own draws")
    bm = on_path(lambda: eng.beam_search(prompts[0], 5, new, head="adaptive"))
    eb = eager_beam_search(eng, prompts[0], 5, new, head="adaptive")
    check(np.array_equal(bm.tokens, eb.tokens) and
          np.array_equal(bm.scores, eb.scores),
          "[heads] adaptive beam(5): graph != eager body")
    g_ex = eng.generate(prompts, new, head="exact")
    g_sc = eng.generate(prompts, new, head="screened-cuda")
    near = {}
    for name, ref, rule in ((svd, g_ex, "exact"),
                            ("screened-cpu", g_sc, "screened-cuda")):
        got = on_path(lambda: eng.generate(prompts, new, head=name))
        name = getattr(name, "name", name)
        near[name] = sum(gap_rule(torch, np, f"[heads] {name} row {i}",
                                  model, params, screen, prompts[i],
                                  got.tokens[i], ref.tokens[i], rule)
                         for i in range(len(prompts)))
    reqs = [ServeRequest(prompt=corpus.sample_batch(1, n, seed=40 + i)[0],
                         max_new=m)
            for i, (n, m) in enumerate(((8, 12), (12, 6), (8, 10),
                                        (12, 16)))]
    plan = [0, 1, 3, 5]

    def stream_run():
        done, ticks, _, _ = drive_stream(eng.open_stream("greedy-mips",
                                                         width=4), reqs, plan)
        return done, ticks
    got, ticks = on_path(stream_run)
    near["greedy-mips stream"] = sum(
        gap_rule(torch, np, f"[heads] greedy-mips stream request {i}", model,
                 params, screen, r.prompt, got[i],
                 eng.generate(r.prompt[None], r.max_new,
                              head="greedy-mips").tokens[0], "exact")
        for i, r in enumerate(reqs))
    check(launches["fused_screened_topk"] == 4 * new and
          launches["screened_logits"] == 2 * new and
          launches["cluster_route"] == 0,
          f"[heads] the path's own runs launched {launches}: want "
          f"{4 * new} fused top-k (greedy and beam, two a step), {2 * new} "
          f"gathers (the sampled rows, two a step) and no route")
    counts_1 = (eng.compiled_step_counts(), eng.host_model_graphs())
    check(all(counts_1[0][(n, "greedy")] == 0
              for n in ("svd", "screened-cpu", "greedy-mips")),
          f"[heads] a host head holds a graph: {counts_1[0]}")
    again = eng.generate(prompts, new, head="adaptive")
    again_svd = eng.generate(prompts, new, head=svd)
    got2, _ = stream_run()
    check(np.array_equal(again.tokens, g_ad.tokens) and
          all(np.array_equal(got2[i], got[i]) for i in got),
          "[heads] a second identical run changed tokens")
    counts_2 = (eng.compiled_step_counts(), eng.host_model_graphs())
    check(counts_2 == counts_1, f"[heads] a second identical run added "
          f"graphs: {counts_1} -> {counts_2}")
    del again_svd
    log(f"[heads] DecodeEngine through adaptive (graphs): greedy "
        f"{len(prompts)}x{new} == its eager body and == the unfused head's "
        f"tokens, fused top-k launched {2 * new} times (two a token, from "
        f"zero; device calls == counted launches), sampled (T = 0.9) == the "
        f"head's own draws, beam(5) == eager; host heads between replays: "
        f"full-rank svd == exact, screened-cpu == screened-cuda, and a "
        f"greedy-mips stream of width 4 (4 joins, {ticks} ticks) == solo "
        f"generate, except rows after a step with a top-2 gap < {GAP}: "
        f"{json.dumps(near)}; a second identical run adds no graph "
        f"(compiled_step_counts "
        f"{json.dumps({'/'.join(k): n for k, n in counts_2[0].items()})}, "
        f"model-only graphs of the host heads {counts_2[1]}); launches of "
        f"the path's own runs (adaptive greedy, sampled, beam(5); svd and "
        f"screened-cpu greedy; the greedy-mips stream), each from zero: "
        f"{json.dumps(launches)}")
    log(f"[heads] profile, adaptive greedy {len(prompts)}x{new} (graphs): "
        f"device busy {busy:.3f} ms of {wall * 1e3:.3f} ms unprofiled wall "
        f"(idle share {idle:.3f}), {n_kern} device kernels; fused_topk_kernel "
        f"{ours['fused_screened_topk'][0]:.3f} ms x"
        f"{ours['fused_screened_topk'][1]}")

    # one decode step's head at B = 4 under the clean-L2 timer
    timer = Timer(torch, reps=30)
    h4 = hte[:4].contiguous()
    steps = time_head_steps(
        torch, timer, {"exact": eng.resolve_head("exact"),
                       "screened-cuda": eng.resolve_head("screened-cuda"),
                       "adaptive": fused}, W, h4, screen, fused,
        (d_fused, DESC_K[-1]))
    with torch.inference_mode():
        n4 = [int(hd.tier_blocks(h4, k)[2].sum())
              for hd, k in ((fused, 1), (d_fused, DESC_K[-1]))]
    log(f"[heads] one step's head at B=4, d=500 (CUDA events, clean L2; "
        f"next(h); adaptive-kernels: its two fused launches alone, {n4[0]} "
        f"of 4 rows descending; adaptive-descend-kernels: the two launches "
        f"of shortlist {DESC_SHORTLIST} at k = {DESC_K[-1]}, {n4[1]} of 4 "
        f"rows descending): " + "; ".join(
            f"{n} {ms:.5f} ms (bound {bd[0]:.5f} ms by {bd[1]})"
            for n, (ms, bd) in steps.items()))
    log(f"[heads] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, steps


# -- the vocab-sharded heads --------------------------------------------------
SHARD_COUNTS = (1, 2, 8)         # [sharded] shards, all on the one card
SHARD_GEMMA = 8                  # [sharded] shards at gemma-2b's vocabulary
SHARD_TWINS = {"exact": "exact-sharded", "screened-cuda": "screened-sharded",
               "adaptive": "adaptive-sharded"}
SHARD_CLIP_V, SHARD_CLIP_K = 1_500, 300   # 8 shards of 256 rows: 6, 7 empty


def shard_launch_parity(torch, np, hd, h, k):
    """Each shard's fused launch of ``hd`` (screened-sharded, local="cuda")
    at ``k``, as the head calls it (local block ids, k clipped to the
    shard's K·V_BLK), against the plain version on the same inputs: values
    and logZ within TOL (−∞ on all-sentinel rows on both), ids equal except
    at near-ties (values within 1e-5 relative). → (max abs error, ids at
    near-ties, all-sentinel shards, shards whose k was clipped)."""
    from repro_torch.core.screening import assign_clusters
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    nbs = hd.Ls // V_BLK
    err, near, empty, clipped = 0.0, 0, 0, 0
    with torch.inference_mode():
        cluster = assign_clusters(hd.v, h).long()
        for Ws, bs, _, blocks in hd.slabs:
            ids = blocks[cluster].contiguous()
            kk = min(k, ids.shape[-1] * V_BLK)
            args = (Ws.view(nbs, V_BLK, -1), bs.view(nbs, V_BLK), h, ids)
            ki, kv, kz = fused_screened_topk(*args, k=kk)
            pi, pv, pz = fused_screened_topk_plain(*args, kk)
            torch.testing.assert_close(kv, pv, **TOL)
            torch.testing.assert_close(kz, pz, **TOL)
            diff = ki != pi
            check(bool(((kv - pv).abs()[diff] <=
                        1e-5 * pv.abs()[diff]).all()),
                  f"[sharded] a shard's fused ids differ from the plain "
                  f"version beyond near-ties (k={kk})")
            near += int(diff.sum())
            live = torch.isfinite(kz)
            err = max(err, float((kv - pv).abs().max()),
                      float((kz - pz)[live].abs().max()) if bool(live.any())
                      else 0.0)
            empty += int(bool((ids == nbs).all()))
            clipped += int(kk < k)
    return err, near, empty, clipped


def phase_sharded_lstm(torch, np, ctx):
    """[sharded] (a) on the trained nmt-deen-lstm, its fitted screen and its
    training counts, at 1, 2 and 8 shards on the one card: through fresh
    engines (graphs), greedy 4 x 16 and beam 5 of each sharded head ==
    its unsharded twin's (exact-sharded / exact and screened-sharded
    local="cuda" / screened-cuda under the gap rule, adaptive-sharded ==
    adaptive), sampled T = 1 (exact-sharded == exact from one seed; the
    others in the vocabulary, the screened one in the fitted candidate
    union), a greedy SpecDecodeStream with an exact-sharded verify (8
    shards) == exact, one graph per (head, kind), none added by a second
    run; fused launches n (screened) and 1 + n (adaptive) a token; one
    profiled replay. → launches of the path's runs, from zero."""
    from repro_torch import heads
    from repro_torch.serving import DecodeEngine, ServeRequest
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    adkw = dict(counts=ctx["counts"], shortlist=SHORTLIST, n_tails=N_TAILS)
    prompts = ctx["corpus"].sample_batch(4, 8, seed=12)
    new, beam = 16, 5
    twin_eng = DecodeEngine(model, params, screen=screen, device="cuda",
                            head_kwargs=adkw)
    want = {t: twin_eng.generate(prompts, new, head=t).tokens
            for t in SHARD_TWINS}
    want_beam = {t: twin_eng.beam_search(prompts[0], beam, new, head=t)
                 for t in SHARD_TWINS}
    want_s = twin_eng.generate(prompts, new, head="exact", temperature=1.0,
                               seed=3).tokens
    del twin_eng
    cand = screen.cand_idx.cpu().numpy()
    n_blk = -(-V // V_BLK)
    words = np.zeros(V, bool)
    for blk in np.unique(cand[cand < n_blk]):
        words[blk * V_BLK:(blk + 1) * V_BLK] = True
    acc, near, per_token, graphs = {}, {}, {}, {}
    for n in SHARD_COUNTS:
        eng = DecodeEngine(model, params, screen=screen, device="cuda")
        kw = dict(device="cuda", W=eng.W, b=eng.b, n_shards=n)
        hds = {"exact": heads.get("exact-sharded", **kw),
               "screened-cuda": heads.get("screened-sharded",
                                          screen=eng.screen, local="cuda",
                                          **kw),
               "adaptive": heads.get("adaptive-sharded", **adkw, **kw)}
        greedy = {}
        for twin, hd in hds.items():
            one = {}
            got = counted(torch, one, lambda: eng.generate(prompts, new,
                                                           head=hd))
            for name, c in one.items():
                acc[name] = acc.get(name, 0) + c
            per_token[f"{hd.name} n={n}"] = one["fused_screened_topk"] / new
            want_fused = {"exact": 0, "screened-cuda": n,
                          "adaptive": 1 + n}[twin] * new
            check(one["fused_screened_topk"] == want_fused and
                  one["cluster_route"] == 0,
                  f"[sharded] {hd.name} n={n} greedy launched {one}, want "
                  f"{want_fused} fused top-k and no route")
            greedy[twin] = got.tokens
            rule = "screened" if twin == "screened-cuda" else "exact"
            if twin == "adaptive":
                check(np.array_equal(got.tokens, want[twin]),
                      f"[sharded] adaptive-sharded n={n} greedy tokens != "
                      f"adaptive's")
            else:
                near[f"{hd.name} n={n}"] = sum(
                    gap_rule(torch, np, f"[sharded] {hd.name} n={n} row {i}",
                             model, params, screen, prompts[i],
                             got.tokens[i], want[twin][i], rule)
                    for i in range(len(prompts)))
            bm = counted(torch, acc, lambda: eng.beam_search(
                prompts[0], beam, new, head=hd))
            wb = want_beam[twin]
            same = np.array_equal(bm.tokens, wb.tokens)
            sc, wsc = float(bm.scores.reshape(-1)[0]), float(
                wb.scores.reshape(-1)[0])
            check(same or abs(sc - wsc) <= 1e-4 * abs(wsc),
                  f"[sharded] {hd.name} n={n} beam({beam}) != {twin}'s")
            near[f"{hd.name} n={n} beam"] = int(not same)
            s = counted(torch, acc, lambda: eng.generate(
                prompts, new, head=hd, temperature=1.0, seed=3))
            check(s.tokens.min() >= 0 and s.tokens.max() < V,
                  f"[sharded] {hd.name} n={n} sampled outside the vocabulary")
            if twin == "exact":
                check(np.array_equal(s.tokens, want_s),
                      f"[sharded] exact-sharded n={n} sampled tokens != "
                      f"exact's from the same seed")
            if twin == "screened-cuda":
                check(bool(words[s.tokens.reshape(-1)].all()),
                      f"[sharded] screened-sharded n={n} sampled outside the "
                      f"fitted candidate union")
        if n == SHARD_COUNTS[-1]:
            spec = eng.open_spec_stream("screened-cuda", hds["exact"],
                                        width=4, draft_len=4)
            reqs = [ServeRequest(prompt=p, max_new=new) for p in prompts]
            got, ticks, _, _ = counted(torch, acc, lambda: drive_stream(
                spec, reqs, [0] * len(reqs)))
            near["spec verify exact-sharded"] = sum(
                gap_rule(torch, np, f"[sharded] spec request {i}", model,
                         params, screen, r.prompt, got[i], want["exact"][i],
                         "exact") for i, r in enumerate(reqs))
            sc = spec.spec_counters()
            spec_line = (f"{ticks} rounds, {sc['accepted']} of "
                         f"{sc['drafted']} drafted tokens accepted")
            prof = hds["screened-cuda"]
            _, wall = host_timed(torch, lambda: eng.generate(prompts, new,
                                                             head=prof))
            busy, idle, ours, n_kern = device_profile(
                torch, f"[sharded] screened-sharded n={n} greedy replay",
                lambda: eng.generate(prompts, new, head=prof), wall)
        counts = eng.compiled_step_counts()
        for twin, hd in hds.items():
            check(all(counts.get((hd.name, kind)) == 1
                      for kind in ("greedy", "decode", "sample")),
                  f"[sharded] n={n}: graphs {counts}")
            again = eng.generate(prompts, new, head=hd)
            check(np.array_equal(again.tokens, greedy[twin]),
                  f"[sharded] {hd.name} n={n}: a second run changed tokens")
        check(eng.compiled_step_counts() == counts,
              f"[sharded] n={n}: a second run added graphs")
        graphs[n] = {f"{k[0]}/{k[1]}": v for k, v in sorted(counts.items())}
        del eng, hds
    log(f"[sharded] nmt-deen-lstm (trained, fitted screen, counts of the "
        f"training tokens; shortlist {SHORTLIST}, {N_TAILS} tails) at "
        f"{list(SHARD_COUNTS)} shards on the one card, fresh engines "
        f"(graphs): greedy {len(prompts)}x{new} and beam({beam}) of "
        f"exact-sharded, screened-sharded (local=\"cuda\") and "
        f"adaptive-sharded == exact, screened-cuda and adaptive (adaptive "
        f"bit for bit), except these rows / beams that first differ after "
        f"a step with a top-2 gap < {GAP} (beams: scores within 1e-4): "
        f"{json.dumps(near)}; sampled T = 1: exact-sharded == exact from "
        f"one seed, the others in the vocabulary and the screened one in "
        f"the fitted candidate union; a greedy SpecDecodeStream (draft "
        f"screened-cuda, verify exact-sharded at {SHARD_COUNTS[-1]} shards, "
        f"width 4, draft_len 4) == exact ({spec_line}); fused top-k "
        f"launches a token {json.dumps(per_token)}; graphs one per (head, "
        f"kind), none added by a second run: {json.dumps(graphs)}")
    log(f"[sharded] profile, screened-sharded at {SHARD_COUNTS[-1]} shards, "
        f"greedy {len(prompts)}x{new} (graphs): device busy {busy:.3f} ms "
        f"(idle share {idle:.3f}), {n_kern} device kernels; "
        f"fused_topk_kernel {ours['fused_screened_topk'][0]:.3f} ms x"
        f"{ours['fused_screened_topk'][1]}; launches of the path's runs "
        f"(from zero): {json.dumps(acc)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return acc


def phase_sharded_gemma(torch, np):
    """[sharded] (b) head calls at gemma-2b's vocabulary (V = 256,000,
    d = 2,048, float32 W, B = 4) with a random 128-word block screen (r =
    100, K = 16) over 8 shards on the one card: exact-sharded ids ==
    exact's (but near-ties), screened-sharded local="cuda" ids and
    log-probs == screened-cuda's (rows routed alike; log-probs 1e-5),
    adaptive-sharded ids == adaptive's; each shard's fused launch against
    its plain version, there and on a 1,500-word slice of the head (shards
    6 and 7 own nothing; k = 300 clipped to a shard's 256 slots); each
    head's call (``next``), eager and captured in a CUDA graph, and one
    shard's launch timed under the clean-L2 timer, beside its bound.
    → (launches of the sharded head calls, from zero; {name: timing
    row})."""
    from repro_torch import heads
    from repro_torch.interop import screen_from_numpy
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(26)
    W = torch.randn((GV, GD), generator=g, device="cuda") * 0.02
    b = torch.randn((GV,), generator=g, device="cuda") * 0.1
    h = torch.randn((4, GD), generator=g, device="cuda")
    n_blk = GV // V_BLK
    rng = np.random.default_rng(26)
    cand = make_screen_blocks(np, 26, n_blk)
    screen = screen_from_numpy(rng.standard_normal((R, GD)).astype(np.float32),
                               cand, (cand < n_blk).sum(1), GV,
                               V_BLK).to("cuda")
    kw = dict(device="cuda", W=W, b=b)
    adkw = dict(shortlist=SHORTLIST, n_tails=N_TAILS)
    un = {"exact": heads.get("exact", **kw),
          "screened-cuda": heads.get("screened-cuda", screen=screen, **kw),
          "adaptive": heads.get("adaptive", **adkw, **kw)}
    kw["n_shards"] = SHARD_GEMMA
    sh = {"exact": heads.get("exact-sharded", **kw),
          "screened-cuda": heads.get("screened-sharded", screen=screen,
                                     local="cuda", **kw),
          "adaptive": heads.get("adaptive-sharded", **adkw, **kw)}
    acc = {}
    near = 0
    with torch.inference_mode():
        for k in (1, 5, 64):
            got = {t: counted(torch, acc, lambda hd=hd: hd.topk_logprobs(h, k))
                   for t, hd in sh.items()}
            ref = {t: hd.topk_logprobs(h, k) for t, hd in un.items()}
            logits = h @ W.T + b
            ids, ref_ids = got["exact"][0], ref["exact"][0]
            diff = ids != ref_ids
            s1 = logits.gather(1, ids.long())
            s2 = logits.gather(1, ref_ids.long())
            check(bool(((s1 - s2).abs()[diff] <= 1e-5 * s2.abs()[diff]).all()),
                  f"[sharded] gemma-vocab exact-sharded k={k}: ids differ "
                  f"from exact's beyond near-ties")
            near += int(diff.sum())
            torch.testing.assert_close(got["exact"][1], ref["exact"][1],
                                       **TOL)
            same = cluster_route(h, screen.v) == torch.argmax(
                h @ screen.v.T, dim=-1)
            check(int(same.sum()) >= 3, "[sharded] gemma-vocab: the route "
                  "kernel and the plain argmax differ on more than one row")
            check(torch.equal(got["screened-cuda"][0][same],
                              ref["screened-cuda"][0][same]),
                  f"[sharded] gemma-vocab screened-sharded k={k}: ids != "
                  f"screened-cuda's")
            torch.testing.assert_close(got["screened-cuda"][1][same],
                                       ref["screened-cuda"][1][same], **TOL)
            check(torch.equal(got["adaptive"][0], ref["adaptive"][0]),
                  f"[sharded] gemma-vocab adaptive-sharded k={k}: ids != "
                  f"adaptive's")
            torch.testing.assert_close(got["adaptive"][1], ref["adaptive"][1],
                                       **TOL)
        check(acc["fused_screened_topk"] > 0, f"[sharded] gemma-vocab: no "
              f"fused launch {acc}")
    err, pnear, empty, _ = shard_launch_parity(torch, np, sh["screened-cuda"],
                                               h, 5)
    small = heads.get("screened-sharded", device="cuda",
                      W=W[:SHARD_CLIP_V].contiguous(),
                      b=b[:SHARD_CLIP_V].contiguous(),
                      screen=screen_from_numpy(
                          screen.v.cpu().numpy(), *small_blocks(np),
                          SHARD_CLIP_V, V_BLK).to("cuda"),
                      n_shards=8, local="cuda")
    e2, n2, empty2, clipped = shard_launch_parity(torch, np, small, h,
                                                  SHARD_CLIP_K)
    check(empty2 >= 2 and clipped > 0, f"[sharded] the 1,500-word slice: "
          f"{empty2} all-sentinel shards, {clipped} clipped, want shards 6 "
          f"and 7 among them and some clipped")

    # one call of each head (a decode step's next) and one shard's launch
    timer = Timer(torch, reps=30)
    hd0 = sh["screened-cuda"]
    nbs = hd0.Ls // V_BLK
    Ws, bs, _, blocks = hd0.slabs[0]
    with torch.inference_mode():
        ids0 = blocks[torch.argmax(h @ hd0.v.T, dim=-1)].contiguous()
        args0 = (Ws.view(nbs, V_BLK, GD), bs.view(nbs, V_BLK), h, ids0)
        fns = {f"{t} {x}": (lambda hd=hd: hd.next(h))
               for t, pair in (("un", un), ("sh", sh))
               for x, hd in pair.items()}
        # the same calls captured, as the engine's decode step runs them:
        # device time without the host's enqueue of each small operation
        fns.update({f"{name} graph": graphed(torch, fn)
                    for name, fn in list(fns.items())})
        fns["shard launch"] = lambda: fused_screened_topk(*args0, k=1)
        fns["shard plain"] = lambda: fused_screened_topk_plain(*args0, 1)
        t = timer.turns(fns)
        live = ids0[ids0 < nbs]
        tiles = int(live.unique().numel())
    B = h.shape[0]
    exact_bound = bound_ms(4 * (GV * (GD + 1) + B * GD), 2 * B * GV * GD)
    bounds = {"exact": exact_bound,
              "screened-cuda": screened_bound(torch, screen, h),
              "adaptive": adaptive_bound(torch, un["adaptive"], h)}
    shard_bound = bound_ms(4 * (tiles * V_BLK * (GD + 1) + B * GD +
                                ids0.numel() + 3 * B),
                           2 * GD * live.numel() * V_BLK)
    rows = {"shard": {"B": B, "K": int(ids0.shape[1]), "n_blk": nbs,
                      "d": GD, "k": 1, "live_tiles": tiles,
                      "ms": t["shard launch"], "plain_ms": t["shard plain"],
                      "bound": shard_bound, "library_ms": None},
            "heads": {x: {"ms": t[f"sh {x}"], "unsharded_ms": t[f"un {x}"],
                          "graph_ms": t[f"sh {x} graph"],
                          "unsharded_graph_ms": t[f"un {x} graph"],
                          "bound_ms": bounds[x][0], "bound_by": bounds[x][1]}
                      for x in sh}}
    log(f"[sharded] gemma-2b vocabulary (V = {GV}, d = {GD}, float32, B = "
        f"{B}) over {SHARD_GEMMA} shards on the one card, k in 1, 5, 64: "
        f"exact-sharded ids == exact's except {near} at near-ties (logits "
        f"within 1e-5 relative), log-probs within 1e-5; screened-sharded "
        f"(local=\"cuda\", per-shard K = {hd0.kb_shard_max} of {K} blocks) "
        f"ids == screened-cuda's and log-probs within 1e-5 on the rows the "
        f"route kernel and the plain argmax route alike; adaptive-sharded "
        f"ids == adaptive's; each shard's fused launch == its plain version "
        f"(max abs err {max(err, e2):.3g}, {pnear + n2} ids at near-ties), "
        f"also on a {SHARD_CLIP_V}-word slice ({empty2} shards all "
        f"sentinel, k = {SHARD_CLIP_K} clipped on {clipped} shards); "
        f"launches of the sharded calls (from zero) {json.dumps(acc)}")
    log(f"[timing] sharded heads at gemma-2b's vocabulary, B = {B}, next(h) "
        f"(CUDA events, median of 30, clean L2; eager, then one replay of "
        f"the call captured in a CUDA graph): " + "; ".join(
            f"{SHARD_TWINS[x]} {r['ms']:.5f} ms / graph {r['graph_ms']:.5f} "
            f"ms against {x} {r['unsharded_ms']:.5f} ms / graph "
            f"{r['unsharded_graph_ms']:.5f} ms (bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']})" for x, r in rows["heads"].items()))
    s = rows["shard"]
    log(f"[timing] fused_screened_topk one shard of 8 at gemma-2b's "
        f"vocabulary (n_blk {nbs}, B = {B}, K = {s['K']}, {tiles} live "
        f"tiles, d = {GD}, k = 1): {s['ms']:.5f} ms, plain {s['plain_ms']:.5f}"
        f" ms, bound {shard_bound[0]:.5f} ms by {shard_bound[1]}, library "
        f"none; phase wall {time.perf_counter() - t_phase:.1f} s")
    del un, sh, small, W
    gc.collect()
    torch.cuda.empty_cache()
    return acc, rows


# -- the op-level cost counter ----------------------------------------------------
COST_SHAPE = (4, 4096)           # [cost] gemma-2b decode: B rows, S cache slots
COST_MEM_TOL = 0.03              # of temp_bytes: the step's peak new storage
                                 # vs temp_bytes + the largest op transient
# [cost] audits these heads, every head the package registers: a fixed list,
# so that a head a phase before registers (screened-cuda-unfused) is not
# audited in a full run and missed in --only cost
COST_HEADS = ("adaptive", "adaptive-sharded", "exact", "exact-sharded",
              "greedy-mips", "lsh-mips", "pca-mips", "screened",
              "screened-cpu", "screened-cuda", "screened-sharded",
              "shortlist", "svd")
COST_HOOK_CALLS = 200_000        # calls timed of the recording hooks, idle


def phase_cost(torch, np, ctx):
    """[cost] (a) on the trained nmt-deen-lstm and its fitted screen:
    ``audit_cost_drift`` over COST_HEADS through one engine on the card (8
    shards for the sharded heads; no error entry); each torch head's op
    FLOPs and bytes == its count on the CPU over the same weights and
    screen; at B = 4 held-out rows the fused screened-cuda call records no
    (B, K·128) float32 result and the unfused one does, fused bytes below
    unfused, both counts == the CPU's, fused ids == unfused ids bit for
    bit. The path's launches are those of the audit and the contract's
    calls; then, counted apart, the route, gather and fused launches
    against their plain versions. The recording hooks' host time a wrapper
    call outside a count. (b) one dry-run record that fits the card:
    gemma-2b decode of 4 rows over 4,096 cache slots (bf16), counted on
    meta: its param bytes == the bytes of the params drawn on the card, its
    FLOPs and bytes == the count of the same step run on the card, and the
    step's peak new storage run for real (``max_memory_allocated`` less
    what was allocated after a warm-up) within COST_MEM_TOL of
    ``temp_bytes`` (the counted peak of the storage the step allocates,
    its results included) plus the largest transient of one op, measured
    by ``op_transients`` (a GEMM's workspace). → (max abs errors, launches
    by path)."""
    from repro_torch import heads
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import cost, ops
    from repro_torch.kernels.fused_topk import fused_screened_topk_plain
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    from repro_torch.launch.dryrun import lower_combo
    from repro_torch.launch.op_cost import count_cost, materializes_f32_buffer
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.serving import DecodeEngine, audit_cost_drift
    from repro_torch.utils import tree_bytes
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    kw = dict(counts=ctx["counts"], shortlist=SHORTLIST, n_tails=N_TAILS,
              n_shards=SHARD_GEMMA, local="cuda")
    names = sorted(COST_HEADS)
    check(set(names) <= set(heads.names()), f"[cost] heads "
          f"{set(names) - set(heads.names())} are not registered")
    paths = {}
    ops.reset_launches()
    eng = DecodeEngine(model, params, screen=screen, device="cuda",
                       head_kwargs=kw)
    drift = audit_cost_drift(eng, names, iters=20, warmup=2)
    check(sorted(drift) == names and
          not [n for n, e in drift.items() if "error" in e],
          f"[cost] the audit: heads {sorted(drift)}, errors "
          f"{ {n: e['error'] for n, e in drift.items() if 'error' in e} }")
    counted = [n for n in names if "op_flops" in drift[n]["measured"]]
    check(set(counted) == {n for n in names if not n.endswith("-sharded")
                           and eng.resolve_head(n).is_jittable},
          f"[cost] op counts for {counted}: every unsharded torch head, "
          f"no host or sharded one")
    cpu_eng = DecodeEngine(model, to_device(params, "cpu"),
                           screen=screen.to("cpu"), device="cpu",
                           head_kwargs=kw)
    cpu = audit_cost_drift(cpu_eng, counted, iters=1, warmup=0)
    for n in counted:
        got, want = drift[n]["measured"], cpu[n]["measured"]
        check((got["op_flops"], got["op_bytes"]) ==
              (want["op_flops"], want["op_bytes"]),
              f"[cost] {n}: op count on the card {got} != the CPU's {want}")
    for n in names:
        e = drift[n]
        m, r = e["measured"], e["ratio"]
        counts = (f"op_flops {m['op_flops']:.6g} op_bytes {m['op_bytes']:.6g}"
                  f" (== the CPU's), ratio flops {r['flops']} bytes "
                  f"{r['bytes']}" if "op_flops" in m else
                  "not counted (host or sharded)")
        log(f"[cost] drift {n}: predicted flops "
            f"{e['predicted']['flops_per_query']:.6g} bytes "
            f"{e['predicted']['bytes_per_query']:.6g}; {counts}; "
            f"{m['wall_s_per_query'] * 1e3:.5f} ms a query (host clock, "
            f"synchronised)")

    # the memory contract on the card, each count == the CPU's
    h = torch.as_tensor(ctx["Hte"][:4], device="cuda").contiguous()
    fused = eng.resolve_head("screened-cuda")
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False, device="cuda")
    cpu_heads = (cpu_eng.resolve_head("screened-cuda"),
                 heads.get("screened-cuda", W=cpu_eng.W, b=cpu_eng.b,
                           screen=cpu_eng.screen, fused=False, device="cpu"))
    B, K = h.shape[0], screen.cand_idx.shape[1]
    with torch.inference_mode():
        (fi, fv), cf = count_cost(fused.topk, h, 5)
        (ui, uv), cu = count_cost(unfused.topk, h, 5)
        cpu_counts = [count_cost(hd.topk, h.cpu(), 5)[1] for hd in cpu_heads]
    check(materializes_f32_buffer(cu, B, K, V_BLK) and
          not materializes_f32_buffer(cf, B, K, V_BLK) and
          cf.bytes_accessed < cu.bytes_accessed,
          f"[cost] memory contract at B={B}, K={K}: unfused tile "
          f"{materializes_f32_buffer(cu, B, K, V_BLK)}, fused tile "
          f"{materializes_f32_buffer(cf, B, K, V_BLK)}, bytes "
          f"{cf.bytes_accessed} vs {cu.bytes_accessed}")
    for got, want in zip((cf, cu), cpu_counts):
        check((got.flops, got.bytes_accessed) ==
              (want.flops, want.bytes_accessed),
              f"[cost] screened-cuda count on the card != the CPU's")
    check(torch.equal(fi, ui) and torch.equal(fv, uv),
          "[cost] fused and unfused ids / values differ")
    # the path: the audit and the contract's calls
    paths["nmt-deen-lstm cost"] = dict(ops.LAUNCHES)
    for name in L2S_KERNELS:
        check(paths["nmt-deen-lstm cost"][name] > 0,
              f"[cost] {name} was not launched on the path")
    # each kernel against its plain version, its launches counted apart
    ops.reset_launches()
    err = {}
    with torch.inference_mode():
        v = fused.screen.v
        route = cluster_route(h, v)
        want_r = cluster_route_plain(h, v)
        check(torch.equal(route, want_r), "[cost] routes differ from the "
              "plain version")
        ids = fused.screen.cand_idx[route.long()].contiguous()
        raw = screened_logits(fused._Wb, fused._bb, h, ids)
        raw_p = screened_logits_plain(fused._Wb, fused._bb, h, ids)
        torch.testing.assert_close(raw, raw_p, **TOL)
        ki, kv, kz = ops.fused_screened_topk(fused._Wb, fused._bb, h, ids, 5)
        pi, pv, pz = fused_screened_topk_plain(fused._Wb, fused._bb, h, ids, 5)
        torch.testing.assert_close(kv, pv, **TOL)
        torch.testing.assert_close(kz, pz, **TOL)
        check(torch.equal(ki, pi), "[cost] fused ids differ from the plain "
              "version's")
    err["cluster_route"] = 0.0
    err["screened_logits"] = float((raw - raw_p).abs().max())
    err["fused_screened_topk"] = max(float((kv - pv).abs().max()),
                                     float((kz - pz).abs().max()))
    parity = {n: c for n, c in ops.LAUNCHES.items() if c}
    # the hooks a wrapper runs outside a count: one suspended() context, a
    # counting() test and a record_kernel() that returns at once
    t0 = time.perf_counter()
    for _ in range(COST_HOOK_CALLS):
        with cost.suspended():
            pass
        cost.counting()
        cost.record_kernel("idle", (), 0, 0)
    hook_us = (time.perf_counter() - t0) / COST_HOOK_CALLS * 1e6
    log(f"[cost] memory contract on the card, B={B}, K={K} tiles, k=5: "
        f"unfused records the ({B}, {K}, {V_BLK}) float32 tile, fused none; "
        f"bytes {cf.bytes_accessed:.6g} fused vs {cu.bytes_accessed:.6g} "
        f"unfused ({cu.bytes_accessed / cf.bytes_accessed:.2f}x), flops "
        f"{cf.flops:.6g} vs {cu.flops:.6g}; each count == the CPU's; fused "
        f"== unfused bit for bit; kernels against their plain versions: "
        f"{json.dumps(err)} (their launches, not on the path: "
        f"{json.dumps(parity)}); path launches (audit and contract calls) "
        f"{json.dumps(paths['nmt-deen-lstm cost'])}; the recording hooks "
        f"outside a count {hook_us:.4f} us a wrapper call (host clock, mean "
        f"of {COST_HOOK_CALLS})")
    del eng, cpu_eng, fused, unfused

    # (b) a dry-run record that fits, against the same step on the card
    Bg, Sg = COST_SHAPE
    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    rec = lower_combo(cfg, ShapeConfig("decode_4x4096", Sg, Bg, "decode"))
    t_dry = time.perf_counter() - t0
    mem = rec["memory"]
    check(rec["fits_one_card"], f"[cost] the dry run says gemma-2b decode "
          f"{Bg} x {Sg} does not fit: {mem}")
    gm = Model(cfg)
    gparams = gm.init(torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    check(tree_bytes(gparams) == mem["param_bytes"],
          f"[cost] param bytes {tree_bytes(gparams)} != the dry run's "
          f"{mem['param_bytes']}")
    step = make_serve_step(gm)
    ops.reset_launches()
    cache = gm.init_cache(Bg, Sg, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (Bg,), dtype=torch.int32,
                        device="cuda")
    pos = torch.tensor(Sg - 96, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        m_pre = torch.cuda.memory_allocated()
        step(gparams, cache, tok, pos)                     # warm-up
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(gparams, cache, tok, pos)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - m0
        _, card = count_cost(step, gparams, cache, tok, pos)
        transients = op_transients(torch, step, gparams, cache, tok, pos)
    paths["gemma-2b cost"] = dict(ops.LAUNCHES)
    # the warm-up, the measured step, the counted one and the watched one
    check(paths["gemma-2b cost"]["cache_slot_update"] == 4 * cfg.num_layers,
          f"[cost] gemma-2b: {paths['gemma-2b cost']['cache_slot_update']} "
          f"cache launches in 4 steps of {cfg.num_layers} layers")
    rl = rec["roofline"]
    check((card.flops, card.bytes_accessed) ==
          (rl["flops_per_dev"], rl["bytes_per_dev"]),
          f"[cost] gemma-2b decode counted on the card ({card.flops}, "
          f"{card.bytes_accessed}) != on meta ({rl['flops_per_dev']}, "
          f"{rl['bytes_per_dev']})")
    # the counter sees the results of ops, not a library's workspace that
    # an op takes and gives back inside its call: add the largest, measured
    temp = mem["temp_bytes"]
    ws_op = max(transients, key=transients.get)
    ws = transients[ws_op]
    rel = abs(peak - temp - ws) / temp
    check(rel <= COST_MEM_TOL, f"[cost] gemma-2b decode: the step's peak "
          f"new storage on the card {peak} B vs the dry run's temp_bytes "
          f"{temp} B + {ws_op}'s transient {ws} B ({rel:.2%} of temp > "
          f"{COST_MEM_TOL:.0%})")
    log(f"[cost] dry run gemma-2b decode {Bg} x {Sg} (bf16 cache) on meta "
        f"in {t_dry:.1f} s: params {rec['params']} ({mem['param_bytes']} B "
        f"== the card's), argument {mem['argument_bytes']} B, temp "
        f"{mem['temp_bytes']} B, flops {rl['flops_per_dev']:.6g}, bytes "
        f"{rl['bytes_per_dev']:.6g} (== the same step counted on the card), "
        f"bound {rl['bound_s'] * 1e3:.4f} ms ({rl['dominant']}); the step "
        f"run for real after a warm-up: peak new storage {peak} B = temp "
        f"{temp} B + the largest op transient, {ws_op}'s {ws} B (a "
        f"workspace held inside the op), {peak - temp - ws:+d} B "
        f"({rel:.3%} of temp; tolerance {COST_MEM_TOL:.0%}); op transients "
        f"over 0: {json.dumps({n: b for n, b in transients.items() if b})};"
        f" the warm-up's lasting growth {m0 - m_pre} B")
    del gparams, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[cost] phase wall {time.perf_counter() - t_phase:.1f} s")
    return err, paths


def op_transients(torch, fn, *args):
    """Run ``fn(*args)`` once on the card with each aten op watched →
    {op name: the most device memory one call of it held beyond its
    results while it ran (a library's workspace, freed before it
    returns)}. The allocator's counters are host-side, so no op waits."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    seen = {}

    def ptrs(tree):
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            held = ptrs((args, kwargs))
            # the allocator hands out blocks of whole 512-byte units
            res = sum(-(-n // 512) * 512 for ptr, n in ptrs(out).items()
                      if ptr not in held)
            extra = torch.cuda.max_memory_allocated() - before - res
            name = func.overloadpacket.__name__
            seen[name] = max(seen.get(name, 0), extra)
            return out

    with Watch():
        fn(*args)
    return seen


def graphed(torch, fn):
    """``fn`` captured in a CUDA graph (run once on the capture stream
    first, outside the capture) → the graph's ``replay``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph.replay


def small_blocks(np):
    """A block screen over SHARD_CLIP_V words (12 tiles): every cluster
    holds 5 of them. → (cand (R, 8), cand_len (R,))."""
    n_blk = -(-SHARD_CLIP_V // V_BLK)
    rng = np.random.default_rng(27)
    cand = np.full((R, 8), n_blk, np.int32)
    for t in range(R):
        cand[t, :5] = np.sort(rng.choice(n_blk, 5, replace=False))
    return cand, np.full(R, 5, np.int32)


def phase_adaptive_hybrid(torch, np, ctx):
    """[heads] adaptive on full-width zamba2-2.7b (random weights, so the
    tiers follow the weight-row norms): greedy 4 x 512 + 32 with shortlist
    2048 fused == unfused tokens (graphs), two fused launches a step counted
    from zero and held to the profiler; shortlist = L against exact under
    the gap rule; the head steps' times at d = 2560. → (launches, times)."""
    from repro_torch.heads import AdaptiveHead
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    prompts = ctx["prompts"]
    cfg = model.cfg
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda",
                       head_kwargs=dict(shortlist=SHORTLIST,
                                        n_tails=N_TAILS))
    fused = eng.resolve_head("adaptive")
    unfused = AdaptiveHead(eng.W, eng.b, shortlist=SHORTLIST,
                           n_tails=N_TAILS, fused=False).prepare()
    full = AdaptiveHead(eng.W, eng.b, shortlist=ZV).prepare()
    lay = fused.layout
    eng.generate(prompts[:, :16], 2, head=fused)       # capture at B = 4
    ops.reset_launches()
    got = eng.generate(prompts, ZNEW, head=fused)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["fused_screened_topk"] == 2 * ZNEW and
          launches["ssd_intra"] == cfg.num_layers and
          launches["cache_slot_update"] == n_attn * (ZNEW - 1),
          f"[heads] zamba2 adaptive greedy: launches {launches}, want "
          f"{2 * ZNEW} fused top-k, {cfg.num_layers} SSD and "
          f"{n_attn * (ZNEW - 1)} cache launches")
    ops.reset_launches()
    profile_counted(torch, "[heads] zamba2 adaptive greedy",
                    lambda: eng.generate(prompts, ZNEW, head=fused))
    un = eng.generate(prompts, ZNEW, head=unfused)
    check(np.array_equal(got.tokens, un.tokens),
          "[heads] zamba2 adaptive fused and unfused tokens differ")
    g_full = eng.generate(prompts, ZNEW, head=full)
    g_ex = eng.generate(prompts, ZNEW, head="exact")
    near = sum(gap_rule(torch, np, f"[heads] zamba2 adaptive L row {i}",
                        model, params, screen, prompts[i], g_full.tokens[i],
                        g_ex.tokens[i], "exact")
               for i in range(ZB))
    with torch.inference_mode():
        h4, _ = model.forward(params, {"tokens": torch.as_tensor(
            prompts[:, :64], device="cuda")})
        h4 = h4[:, -1].contiguous()
    dkw = dict(shortlist=DESC_SHORTLIST, n_tails=N_TAILS)
    d_fused = AdaptiveHead(eng.W, eng.b, **dkw).prepare()
    d_unfused = AdaptiveHead(eng.W, eng.b, fused=False, **dkw).prepare()
    down, d_err, d_near = descent_check(
        torch, "[heads] zamba2 adaptive descent", d_fused, d_unfused, h4,
        DESC_K)
    check(any(0 < n < ZB for n in down.values()), f"[heads] zamba2 "
          f"adaptive descent: no k mixed descending and sentinel rows in "
          f"one tail launch ({down})")
    with torch.inference_mode():
        descend = fused.tier_blocks(h4, 1)[2]
    timer = Timer(torch, reps=30)
    steps = time_head_steps(
        torch, timer, {"exact": eng.resolve_head("exact"),
                       "screened-cuda": eng.resolve_head("screened-cuda"),
                       "adaptive": fused}, eng.W, h4, eng.screen, fused,
        (d_fused, DESC_K[-1]))
    log(f"[heads] zamba2-2.7b adaptive (weight-norm tiers, shortlist "
        f"{SHORTLIST}, {N_TAILS} tails: nb0 {lay.nb0}, kb {lay.kb}, n_blk "
        f"{lay.n_blk}) greedy {ZB}x{ZT}+{ZNEW} through graphs: fused == "
        f"unfused tokens; launches from zero {json.dumps(launches)} (fused "
        f"top-k two a token; device calls == counted launches); shortlist = "
        f"L == exact tokens except {near} rows after a step with a top-2 gap "
        f"< {GAP}; rows descending at the step timed: "
        f"{int(descend.sum())} of {ZB}; shortlist {DESC_SHORTLIST} (nb0 "
        f"{d_fused.layout.nb0}, kb {d_fused.layout.kb}) at that step: rows "
        f"descending by k {json.dumps(down)}, fused == unfused bit for bit, "
        f"the tail launch against its plain version max abs err {d_err:.3g} "
        f"({d_near} ids differ at near-ties)")
    log(f"[heads] one step's head at B=4, d=2560 (CUDA events, clean L2; "
        f"next(h); adaptive-kernels: its two fused launches alone; "
        f"adaptive-descend-kernels: those of shortlist {DESC_SHORTLIST} at "
        f"k = {DESC_K[-1]}, {down[DESC_K[-1]]} of {ZB} rows descending): " +
        "; ".join(
            f"{n} {ms:.5f} ms (bound {bd[0]:.5f} ms by {bd[1]})"
            for n, (ms, bd) in steps.items()))
    log(f"[heads] zamba2 adaptive phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, steps


# -- the dense family: gemma-2b, starcoder2-3b, qwen1.5-110b --------------------
# gemma-2b (arXiv 2403.08295) in its config's bfloat16: 18 layers, d = 2048,
# MQA (kv = 1, hd = 256), GeGLU d_ff = 16,384, V = 256,000 (2,000 tiles),
# tied; 4 prompts of 512, 32 new, max_len 544 (34 pages of 16 when paged)
GD, GV = 2048, 256_000
GB, GT, GNEW, GMAX, GPAGE = 4, 512, 32, 544, 16
GSPEC_MAX = GMAX + 8                 # room for the drafts past the last token
DENSE_W = 4                          # [dense] paged / spec stream width
SD = 3072                            # starcoder2-3b's d_model
QD, Q_LAYERS = 8192, 2               # qwen1.5-110b's d_model; its depth here


def dense_model(torch, np, name, tag, layers=None, seed=0, full=False):
    """A full-width dense or moe config in its bfloat16, drawn on the card
    from a seeded CUDA generator (``layers``: its depth cut to that many), a
    random screen (r = 100, K = 16 over its tiles) and (``full``) its full
    cover. → dict (``rng`` goes on drawing inputs)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves

    cfg = get_config(name)
    full_depth = cfg.num_layers
    if layers is not None:
        cfg = replace(cfg, num_layers=layers)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    check(cfg.dtype == "bfloat16" and
          all(t.dtype == torch.bfloat16 for t in leaves),
          f"{name}: weights not in its config's bfloat16")
    cut = (f" (depth cut from {full_depth} to {cfg.num_layers} layers: "
           f"{full_depth} do not fit one card)" if layers is not None else "")
    log(f"{tag} {name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads (kv {cfg.num_kv_heads}, hd {cfg.head_dim}), "
        f"{cfg.mlp_activation} d_ff={cfg.d_ff}, V={cfg.vocab_size}, "
        f"{'tied' if cfg.tie_embeddings else 'untied lm_head'}, {cfg.norm}"
        f"{', qkv bias' if cfg.qkv_bias else ''}"
        f"{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}"
        f"{f', window {cfg.sliding_window}' if cfg.sliding_window else ''}"
        f"{cut}: {n_params} parameters "
        f"drawn on the card in {t_init:.1f} s, bfloat16, "
        f"{nbytes / 1e9:.3f} GB; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(seed + 1)
    d, vocab = cfg.d_model, cfg.vocab_size
    n_blk = -(-vocab // V_BLK)
    v = rng.standard_normal((R, d)).astype(np.float32)
    cand = make_screen_blocks(np, seed + 8, n_blk)
    out = dict(model=model, params=params, rng=rng, n_params=n_params,
               nbytes=nbytes,
               screen=screen_from_numpy(v, cand, (cand < n_blk).sum(1), vocab,
                                        V_BLK))
    if full:
        idx, lens = candidates_to_padded(np.ones((R, n_blk), bool), vocab,
                                         block=V_BLK)
        out["full"] = screen_from_numpy(v, idx, lens, vocab, V_BLK)
    return out


def exact_gap_fn(torch, eng):
    """The deciding top-2 gap of the exact head at hidden states h (its
    bf16 logits, widened)."""
    def gap(h):
        top = (h @ eng.W.T + eng.b).float().topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).cpu().numpy()
    return gap


def step_weight_bytes(params):
    """(bytes of the weights every decode step reads: the layers' and the
    final norm's, bytes of the exact head's W and b)."""
    from repro_torch.tree import tree_leaves
    stack = sum(t.numel() * t.element_size()
                for t in tree_leaves(params["stack"]))
    emb = params["embed"]
    W, b = emb.get("lm_head", emb["embedding"]), emb["lm_bias"]
    return stack, W.numel() * W.element_size() + b.numel() * b.element_size()


def head_rows(torch, timer, hx, hs, W, screen, h):
    """One decode step's head at ``h`` (B, d) bf16, in turns under the
    clean-L2 timer: exact ``hx`` (a bf16 GEMV over the vocabulary ``W``
    and an argmax) and screened-cuda ``hs`` (route + fused over
    ``screen``), with their bounds. → ({name: (ms, bound)}, distinct
    tiles)."""
    hs = hs.prepare()
    B, d = h.shape
    L = W.shape[0]
    with torch.inference_mode():
        t = timer.turns({"exact": lambda: hx.next(h),
                         "screened-cuda": lambda: hs.next(h)})
        cl = torch.argmax(h.float() @ screen.v.T, dim=-1)
        blocks = screen.cand_idx[cl]
        n_blk = -(-L // V_BLK)
        tiles = int(blocks[blocks < n_blk].unique().numel())
        per_row = int((blocks < n_blk).sum())
    bounds = {"exact": bound_ms(2 * (L * (d + 1) + B * d), 2 * B * L * d),
              "screened-cuda": bound_ms(
                  4 * screen.v.numel() + 2 * tiles * V_BLK * (d + 1) +
                  2 * B * d, 2 * d * (B * screen.r + per_row * V_BLK))}
    return {n: (t[n], bounds[n]) for n in t}, tiles


def phase_dense_gemma(torch, np):
    """[dense] gemma-2b at full width in its config's bfloat16 (2.5 B
    parameters drawn on the card) on DecodeEngine(device="cuda",
    cache_dtype=bfloat16, max_len=544): greedy 4 x 512 + 32 through
    exact, the plain `screened` head and screened-cuda fused and unfused
    (fused == unfused tokens; screened-cuda == the plain head under the
    bf16 gap rule), beam 4, a sampled run (== the head's own draws), a
    full-cover screen (2,000 tiles a row) whose screened-cuda tokens equal
    exact's under the same rule; graphs == the eager step bodies bit for
    bit (greedy exact and screened-cuda, beam); launches from zero (the
    cache pair 18 a decode step, the bf16 L2S bodies only); profiles of
    the unfused and the fused run (device calls == counted launches of
    the route, gather, fused and cache-pair kernels; the fused run's idle
    share); on the host clock the
    decode step (median of 8 replays, both heads) and prefill tokens/s;
    one step's exact head against screened-cuda's in device time (clean
    L2), and the weight-read bound of a step. → (launches of the path,
    the model dict, numbers for the kernels line)."""
    g = dense_model(torch, np, "gemma-2b", "[dense]", full=True)
    cfg = g["model"].cfg
    check((cfg.d_model, cfg.vocab_size, cfg.num_kv_heads, cfg.head_dim,
           cfg.num_layers) == (GD, GV, 1, 256, 18),
          "gemma-2b: config drifted from the smoke's shapes")
    prompts = g["rng"].integers(0, GV, (GB, GT))
    g["prompts"] = prompts
    return serve_bf16(torch, np, "[dense]", g, prompts, GNEW, GMAX), g


def serve_bf16(torch, np, tag, g, prompts, new, max_len):
    """The greedy, beam, sampled and full-cover runs of a full-width model
    in bf16 (``g`` from ``dense_model``, with its full cover) on
    DecodeEngine(device="cuda", cache_dtype=bfloat16, max_len=max_len),
    prompts (B, T) and ``new`` tokens, held as ``phase_dense_gemma`` says;
    logged under ``tag``. → launches of the path's runs."""
    from repro_torch import heads
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine
    from repro_torch.testing import (eager_beam_search, eager_generate,
                                     head_sampled_generate)

    model, params = g["model"], g["params"]
    cfg = model.cfg
    name, d, V_ = cfg.name, cfg.d_model, cfg.vocab_size
    B, T = prompts.shape
    kw = dict(cache_dtype=torch.bfloat16, device="cuda")
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=max_len,
                       **kw)
    eng_full = DecodeEngine(model, params, screen=g["full"],
                            max_len=max_len, **kw)
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    packed = eng.resolve_head("screened-cuda")
    check(packed.prepare()._Wb.dtype == torch.bfloat16 and
          packed.packed_shape == (-(-V_ // V_BLK), V_BLK, d),
          f"{name}: packed head {packed.packed_shape}")
    for e in (eng, eng_full):                     # warm-up: loads, graphs
        e.generate(prompts[:, :16], 2, head="screened-cuda")
        e.generate(prompts[:, :16], 2, head="exact")
    t_prefill = prefill_s(torch, model, params, prompts, max_len,
                          torch.bfloat16)

    ops.reset_launches()
    exact, t_exact = host_timed(torch, lambda: eng.generate(prompts, new,
                                                            head="exact"))
    scr, t_scr = host_timed(torch, lambda: eng.generate(
        prompts, new, head="screened-cuda"))
    scr_u = eng.generate(prompts, new, head=unfused)
    beam, t_beam = host_timed(torch, lambda: eng.beam_search(
        prompts[0], 4, new, head="screened-cuda"))
    smp = eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                       seed=21)
    f_exact = eng_full.generate(prompts, new, head="exact")
    f_scr = eng_full.generate(prompts, new, head="screened-cuda")
    launches = dict(ops.LAUNCHES)
    n_runs = 6                                   # generate runs and the beam
    for hname, r in (("exact", exact), ("screened-cuda", scr),
                     ("unfused", scr_u), ("sampled", smp)):
        check(r.tokens.shape == (B, new) and r.tokens.min() >= 0 and
              r.tokens.max() < V_, f"{tag} {name} {hname}: tokens out of "
              f"range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          f"{tag} {name}: screened-cuda fused and unfused tokens differ")
    check(beam.tokens.shape == (1, new) and np.isfinite(beam.scores).all(),
          f"{tag} {name} beam search: bad result")
    check(launches["cache_slot_update"] == cfg.num_layers * (new - 1) *
          (n_runs + 1),
          f"{tag} {name}: launches {launches}, expected "
          f"{cfg.num_layers} cache pairs a decode step")
    check(all(launches[k] > 0 for k in BF16_KERNELS) and
          not any(launches[k] for k in L2S_KERNELS),
          f"{tag} {name}: the bf16 L2S bodies did not carry the path: "
          f"{launches}")
    own = head_sampled_generate(eng, prompts, new, "screened-cuda", 1.0,
                                1.0, 21)
    check(np.array_equal(smp.tokens, own),
          f"{tag} {name}: graph-sampled tokens differ from the head's own "
          "sample draws")

    plain = eng.generate(prompts, new, head="screened")
    near_plain = bf16_gap_rule(torch, np, f"{tag} {name} against plain",
                               model, params, prompts, scr.tokens,
                               plain.tokens, max_len,
                               screened_gap_fn(torch, eng))
    near_full = bf16_gap_rule(torch, np, f"{tag} {name} full cover", model,
                              params, prompts, f_scr.tokens, f_exact.tokens,
                              max_len, exact_gap_fn(torch, eng))

    # graphs == the eager step bodies, bit for bit, with equal launches
    ops.reset_launches()
    e_runs = {n: eager_generate(eng, prompts, new, head=n)
              for n in ("exact", "screened-cuda")}
    e_beam = eager_beam_search(eng, prompts[0], 4, new, head="screened-cuda")
    torch.cuda.synchronize()
    e_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    g_runs = {n: eng.generate(prompts, new, head=n)
              for n in ("exact", "screened-cuda")}
    g_beam = eng.beam_search(prompts[0], 4, new, head="screened-cuda")
    torch.cuda.synchronize()
    g_launches = dict(ops.LAUNCHES)
    check(all(np.array_equal(g_runs[n].tokens, e_runs[n].tokens)
              for n in e_runs) and
          np.array_equal(g_beam.tokens, e_beam.tokens) and
          np.array_equal(g_beam.scores, e_beam.scores) and
          g_launches == e_launches,
          f"{tag} {name}: graph replays differ from the eager step "
          f"bodies (launches {g_launches} against {e_launches})")
    counts = eng.compiled_step_counts()

    # the gather kernel runs on the unfused head: held to the profiler too
    profile_counted(torch, f"{tag} {name} greedy screened-cuda unfused",
                    lambda: eng.generate(prompts, new, head=unfused))
    kern = profile_counted(torch, f"{tag} {name} greedy screened-cuda",
                           lambda: eng.generate(prompts, new,
                                                head="screened-cuda"))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    step_ms = median_step_ms(torch, eng, "screened-cuda", prompts, 8,
                             eager=False)
    step_x_ms = median_step_ms(torch, eng, "exact", prompts, 8, eager=False)
    timer = Timer(torch)
    h = torch.randn((B, d), generator=torch.Generator().manual_seed(90))
    heads_t, tiles = head_rows(torch, timer, eng.resolve_head("exact"),
                               eng.resolve_head("screened-cuda"), eng.W,
                               eng.screen, h.cuda().to(torch.bfloat16))
    stack_b, head_b = step_weight_bytes(params)
    scr_b = 4 * g["screen"].v.numel() + tiles * V_BLK * (d + 1) * 2
    tok = B * new
    log(f"{tag} {name} bf16 weights {g['nbytes'] / 1e9:.3f} GB; packed "
        f"head {packed.packed_shape} bf16 {packed.packed_nbytes / 1e6:.1f} MB")
    log(f"{tag} {name} d={d} V={V_} on DecodeEngine(device='cuda', "
        f"max_len={max_len}, cache_dtype=bfloat16): greedy {B}x{T}+{new} "
        f"exact {t_exact:.3f} s ({tok / t_exact:.1f} tok/s), screened-cuda "
        f"{t_scr:.3f} s ({tok / t_scr:.1f} tok/s), beam(4) {t_beam:.3f} s "
        f"(score {float(beam.scores[0]):.4f}); fused == unfused tokens; "
        f"sampled T=1 == the head's own draws; screened-cuda == the plain "
        f"screened head's except rows first differing after a step with a "
        f"gap < {GAP_BF16}: {near_plain}; full cover (K={g['full'].c_max}) "
        f"screened-cuda == exact under the same rule: {near_full}")
    log(f"{tag} {name} graphs == eager step bodies bit for bit (greedy "
        f"exact and screened-cuda, beam 4; launches equal, each side from "
        f"zero: {json.dumps(g_launches)}); compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }")
    log(f"{tag} {name} profile, greedy {B}x{T}+{new} screened-cuda: "
        f"device busy {busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled "
        f"wall (idle share {1 - busy_ms / (t_scr * 1e3):.3f}), "
        f"{sum(e.count for e in kern)} device kernels; "
        f"{fused_share(kern, busy_ms, 'fused_screened_topk_bf16')}; top "
        f"kernels: " +
        "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top))
    log(f"{tag} {name} host clock, information only: decode step (median "
        f"of 8 graph replays, B={B}) screened-cuda {step_ms:.3f} ms, exact "
        f"{step_x_ms:.3f} ms; prefill {B}x{T} {t_prefill:.3f} s "
        f"({B * T / t_prefill:.0f} tok/s)")
    log(f"{tag} {name} one step's head, device time (clean L2, CUDA "
        f"events, B={B}): exact {heads_t['exact'][0]:.5f} ms (bound "
        f"{heads_t['exact'][1][0]:.5f} ms, {heads_t['exact'][1][1]}), "
        f"screened-cuda {heads_t['screened-cuda'][0]:.5f} ms (bound "
        f"{heads_t['screened-cuda'][1][0]:.5f} ms, "
        f"{heads_t['screened-cuda'][1][1]}; {tiles} distinct tiles), ratio "
        f"{heads_t['exact'][0] / heads_t['screened-cuda'][0]:.1f}")
    log(f"{tag} {name} weight-read bound of a decode step at 3.35 TB/s: "
        f"layers {stack_b / 1e9:.4f} GB + exact head {head_b / 1e9:.4f} GB = "
        f"{(stack_b + head_b) / HBM_BYTES_PER_S * 1e3:.4f} ms; with "
        f"screened-cuda's {scr_b / 1e6:.2f} MB of head instead "
        f"{(stack_b + scr_b) / HBM_BYTES_PER_S * 1e3:.4f} ms; the exact head "
        f"is {head_b / (stack_b + head_b):.1%} of the exact step's bytes")
    log(f"{tag} {name} launches on the path ({n_runs} generate runs and "
        f"a beam, counted from zero): {json.dumps(launches)}")
    return launches


def dense_traffic(np, varied=False, n=8):
    """[dense] paged's requests: 2 prompts of 256 tokens, each with a
    distinct suffix of 40 tokens (``varied``: of 16-61 tokens), 16 new."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(31)
    bases = rng.integers(0, GV, (2, 256))
    return [ServeRequest(prompt=np.concatenate(
        [bases[i % 2], rng.integers(0, GV, 16 + (i * 13) % 46 if varied
                                    else 40)]),
        max_new=16) for i in range(n)]


def phase_dense_paged(torch, np, g):
    """[dense] gemma-2b paged: a width-4 PagedDecodeStream (pages of 16,
    544 = 34 pages a row) over 8 requests sharing 2 prompts of 256 tokens
    (prompts of one length, 296) == a plain width-4 DecodeStream bit for
    bit, both screened-cuda; radix hits and prefill tokens skipped; the
    same with suffixes of 16-61 tokens, equal but after near ties (a
    shared page holds the K/V of another prompt's prefill, and on the card
    a prefill's rows depend in their last bits on the prompt's length,
    through the GEMMs' kernel choice); the paged step against the plain
    one (host clock per tick); a profile of the paged drain (device calls
    == counted launches); then a ContinuousScheduler drain on a pool too
    small for the traffic (PoolExhausted, preemption, completed requests
    bit-identical). → launches of the path's runs."""
    from repro_torch.serving import (DecodeEngine, PagePool, ServeResult,
                                     StaticPolicy)
    model, params = g["model"], g["params"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=GMAX,
                       cache_dtype=torch.bfloat16, device="cuda")
    reqs = dense_traffic(np)
    plan = [0] * len(reqs)
    head = "screened-cuda"
    plain, _, _, plain_s = drive_stream(eng.open_stream(head, width=DENSE_W),
                                        reqs, plan)
    acc = {}
    pool = PagePool(256, GPAGE)
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        eng.open_paged_stream(pool, head=head, width=DENSE_W), reqs, plan))
    check(all(np.array_equal(got[i], plain[i]) for i in plain),
          "[dense] gemma-2b paged tokens differ from the plain stream's")
    rx = pool.radix.telemetry()
    varied = dense_traffic(np, varied=True)
    v_plain, _, _, _ = drive_stream(eng.open_stream(head, width=DENSE_W),
                                    varied, plan)
    v_got, _, _, _ = counted(torch, acc, lambda: drive_stream(
        eng.open_paged_stream(PagePool(256, GPAGE), head=head,
                              width=DENSE_W), varied, plan))
    near_varied = []
    for i, r in enumerate(varied):
        if not np.array_equal(v_got[i], v_plain[i]):
            near_varied += [(i,) + d_[1:] for d_ in bf16_gap_rule(
                torch, np, f"[dense] paged, varied lengths, request {i}",
                model, params, r.prompt[None], v_got[i][None],
                v_plain[i][None], GMAX, screened_gap_fn(torch, eng))]
    check(rx["tokens_hit"] > 0 and pool.store.k.dtype == torch.bfloat16,
          f"[dense] paged: no radix hit: {rx}")
    check(acc["cache_slot_update"] == 0 and
          acc["fused_screened_topk_bf16"] > 0,
          f"[dense] paged: launches {acc}")
    # one graph per paged slab, and a paged slab serves one store: the two
    # pools above hold two
    counts = eng.compiled_step_counts()
    check(counts.get((head, "greedy-paged")) == 2,
          f"[dense] paged: compiled_step_counts {counts}")
    pool2 = PagePool(256, GPAGE)
    _, t_drain = host_timed(torch, lambda: drive_stream(
        eng.open_paged_stream(pool2, head=head, width=DENSE_W), reqs, plan))
    busy, idle, ours, n_kern = device_profile(
        torch, "[dense] gemma-2b paged drain", lambda: drive_stream(
            eng.open_paged_stream(PagePool(256, GPAGE), head=head,
                                  width=DENSE_W), reqs, plan), t_drain)
    log(f"[dense] gemma-2b paged: PagedDecodeStream width {DENSE_W}, page "
        f"{GPAGE}, {len(reqs)} requests on 2 shared prompts of 256 tokens "
        f"(+ 40 distinct), 16 new: tokens == a plain width-{DENSE_W} "
        f"{head} stream bit for bit; radix lookups {rx['lookups']}, hits "
        f"{rx['lookup_hits']}, prompt tokens on shared pages "
        f"{rx['tokens_hit']} of {rx['tokens_total']} (hit rate "
        f"{rx['hit_rate']:.4f}; the join still prefills solo), COW copies "
        f"{pool.cow_copies}, peak pages {pool.peak_in_use}, store "
        f"{pool.store.nbytes / 2 ** 20:.1f} MiB ({pool.bytes_per_page()} B a "
        f"page); compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }; "
        f"with suffixes of 16-61 tokens: == the plain stream but requests "
        f"first differing after a step with a gap < {GAP_BF16} (request, "
        f"step, gap): {near_varied}")
    log(f"[dense] gemma-2b paged step against the plain step (host clock per "
        f"tick ending in the guard's copy, information only): paged median "
        f"{statistics.median(step_s) * 1e3:.3f} ms over {ticks} ticks, plain "
        f"median {statistics.median(plain_s) * 1e3:.3f} ms over "
        f"{len(plain_s)}; profile of the paged drain: device busy "
        f"{busy:.3f} ms of {t_drain * 1e3:.3f} ms (idle share {idle:.3f}), "
        f"{n_kern} device kernels; per launch: " +
        "; ".join(f"{k} {ms / n * 1e3:.2f} us x{n}"
                  for k, (ms, n) in ours.items()))
    # the scheduler's streams are LSTM_W wide: its plain twin is too
    plain8, _, _, _ = drive_stream(eng.open_stream(head, width=LSTM_W), reqs,
                                   plan)
    small = PagePool(41, GPAGE)                 # 40 pages for 8 requests
    out, sched, _ = counted(torch, acc, lambda: run_sched(
        eng, reqs, StaticPolicy(head), per_tick=len(reqs), kv_pool=small))
    snap = sched.stats.snapshot()
    done = [i for i, r in enumerate(out) if isinstance(r, ServeResult)]
    check(len(out) == len(reqs) and snap["pool"]["stalled_ticks"] > 0 and
          snap["preempted"] > 0 and done,
          f"[dense] paged: the small pool's drain: {len(out)} results, "
          f"stalled {snap['pool']['stalled_ticks']} ticks, preempted "
          f"{snap['preempted']}, {len(done)} completed")
    check(all(np.array_equal(out[i].tokens, plain8[i]) for i in done),
          "[dense] paged: a completed request of the small pool's drain "
          "differs from a plain width-8 stream's")
    log(f"[dense] gemma-2b ContinuousScheduler(max_slots={LSTM_W}, kv_pool="
        f"PagePool({small.num_pages}, {GPAGE})) over the {len(reqs)} "
        f"requests at once: PoolExhausted stalled "
        f"{snap['pool']['stalled_ticks']} ticks, preempted "
        f"{snap['preempted']}, completed {len(done)} (== a plain width-"
        f"{LSTM_W} stream bit for bit), every request ended with a result in "
        f"{snap['ticks']} ticks")
    log(f"[dense] gemma-2b paged launches of the path's own runs (from "
        f"zero): {json.dumps(acc)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return acc


def phase_dense_spec(torch, np, g):
    """[dense] gemma-2b spec: a width-4 SpecDecodeStream (draft
    screened-cuda on the random screen, verify exact, draft_len 4) over 4
    prompts of 512, 32 new: tokens == a plain width-4 exact stream under
    the bf16 gap rule, rejections > 0, no snapshot ring (0 MiB, no row
    restored), a profiled round; the round's host time against the plain
    step's. → launches of the path's run."""
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params = g["model"], g["params"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=GSPEC_MAX,
                       cache_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(32)
    prompts = rng.integers(0, GV, (DENSE_W, GT))
    reqs = [ServeRequest(prompt=p, max_new=GNEW) for p in prompts]
    plan = [0] * len(reqs)
    plain, _, _, plain_s = drive_stream(eng.open_stream("exact",
                                                        width=DENSE_W),
                                        reqs, plan)
    acc = {}
    s = eng.open_spec_stream("screened-cuda", "exact", width=DENSE_W,
                             draft_len=SPEC_N)
    t0 = time.perf_counter()
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        s, reqs, plan))
    wall = time.perf_counter() - t0
    want = np.stack([plain[i] for i in range(len(reqs))])
    near = bf16_gap_rule(torch, np, "[dense] gemma-2b spec", model, params,
                         prompts, np.stack([got[i] for i in range(len(reqs))]),
                         want, GSPEC_MAX, exact_gap_fn(torch, eng))
    c = s.spec_counters()
    check(c["drafted"] - c["accepted"] > 0,
          f"[dense] spec: no draft was rejected: {c}")
    slab = eng._lend_stream_slab(DENSE_W, s._slab_key(), spec_depth=SPEC_N)
    ring = slab.spec.ring_nbytes
    eng._return_stream_slab(slab)
    check(ring == 0 and s.restored_rows == 0 and not s._snapshot,
          f"[dense] spec: a snapshot ring of {ring} bytes, "
          f"{s.restored_rows} rows restored")
    s2 = eng.open_spec_stream("screened-cuda", "exact", width=DENSE_W,
                              draft_len=SPEC_N)
    for i, r in enumerate(reqs):
        s2.join(r, tag=i)
    kern = profile_counted(torch, "[dense] gemma-2b spec round", s2.step)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    while s2.n_active:
        s2.step()
    log(f"[dense] gemma-2b spec: SpecDecodeStream width {DENSE_W}, draft "
        f"screened-cuda (random screen), verify exact, draft_len {SPEC_N}, "
        f"{len(reqs)} prompts of {GT}, {GNEW} new, max_len {GSPEC_MAX}: "
        f"tokens == a plain width-{DENSE_W} exact stream except rows first "
        f"differing after a step with a gap < {GAP_BF16}: {near}; "
        f"{spec_summary(s, step_s)}; live draft length at the end "
        f"{s.controller.n}; no snapshot ring ({ring / 2 ** 20:.1f} MiB), "
        f"rollback by position alone; {ticks} rounds in {wall:.3f} s against "
        f"the plain stream's {len(plain_s)} steps at median "
        f"{statistics.median(plain_s) * 1e3:.3f} ms (host clock); one "
        f"profiled round (the first after the joins): device busy "
        f"{busy:.3f} ms; launches of the run (from zero): {json.dumps(acc)}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return acc


def dense_greedy(torch, np, tag, g, T, new, max_len):
    """Greedy 4 x T + new through exact, screened-cuda and the plain
    `screened` head on a full-width dense model in bf16: screened-cuda ==
    the plain head under the bf16 gap rule; launches from zero over the
    exact and screened-cuda runs (the cache pair a layer a decode step,
    only the bf16 L2S bodies). → launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine
    model, params = g["model"], g["params"]
    cfg = model.cfg
    prompts = g["rng"].integers(0, cfg.vocab_size, (GB, T))
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=max_len,
                       cache_dtype=torch.bfloat16, device="cuda")
    for name in ("screened-cuda", "exact"):
        eng.generate(prompts[:, :16], 2, head=name)
    ops.reset_launches()
    exact, t_exact = host_timed(torch, lambda: eng.generate(prompts, new,
                                                            head="exact"))
    scr, t_scr = host_timed(torch, lambda: eng.generate(
        prompts, new, head="screened-cuda"))
    launches = dict(ops.LAUNCHES)
    check(launches["cache_slot_update"] == 2 * cfg.num_layers * (new - 1) and
          launches["cluster_route_bf16"] == launches[
              "fused_screened_topk_bf16"] == new and
          not any(launches[k] for k in L2S_KERNELS),
          f"{tag}: launches {launches}")
    for r in (exact, scr):
        check(r.tokens.shape == (GB, new) and r.tokens.min() >= 0 and
              r.tokens.max() < cfg.vocab_size, f"{tag}: tokens out of range")
    plain = eng.generate(prompts, new, head="screened")
    near = bf16_gap_rule(torch, np, f"{tag} against plain", model, params,
                         prompts, scr.tokens, plain.tokens, max_len,
                         screened_gap_fn(torch, eng))
    step_ms = median_step_ms(torch, eng, "screened-cuda", prompts, 8,
                             eager=False)
    tok = GB * new
    log(f"{tag} greedy {GB}x{T}+{new} on DecodeEngine(device='cuda', "
        f"max_len={max_len}, cache_dtype=bfloat16): exact {t_exact:.3f} s "
        f"({tok / t_exact:.1f} tok/s), screened-cuda {t_scr:.3f} s "
        f"({tok / t_scr:.1f} tok/s); screened-cuda == the plain screened "
        f"head's except rows first differing after a step with a gap < "
        f"{GAP_BF16}: {near}; decode step (median of 8 graph replays, host "
        f"clock) {step_ms:.3f} ms; launches (from zero, exact and "
        f"screened-cuda): {json.dumps(launches)}")
    return launches


def phase_dense_starcoder2(torch, np):
    """[dense] starcoder2-3b at full width in bf16 (30 layers, d = 3072,
    layernorm, gelu, qkv biases, GQA kv = 2 hd = 128; V = 49,152):
    greedy 4 x 128 + 16 through exact, screened-cuda and the plain head.
    → launches."""
    s = dense_model(torch, np, "starcoder2-3b", "[dense]", seed=3)
    check(s["model"].cfg.d_model == SD, "starcoder2-3b: config drifted")
    out = dense_greedy(torch, np, "[dense] starcoder2-3b", s, 128, 16, 144)
    del s
    return out


def phase_dense_qwen(torch, np):
    """[dense] qwen1.5-110b at its full widths (d = 8192, 64 heads, kv 8,
    SwiGLU d_ff = 49,152, V = 152,064, untied lm_head, qkv biases) cut to
    2 of its 80 layers, in bf16: greedy 4 x 128 + 16 through exact and
    screened-cuda, held to the plain head; the route kernel at d = 8192.
    → launches."""
    q = dense_model(torch, np, "qwen1.5-110b", "[dense]", layers=Q_LAYERS,
                    seed=4)
    check(q["model"].cfg.d_model == QD, "qwen1.5-110b: config drifted")
    out = dense_greedy(torch, np, "[dense] qwen1.5-110b", q, 128, 16, 144)
    del q
    return out


def cli_dense(torch):
    """[serve-cli] ``python -m repro_torch.launch.serve --arch gemma-2b
    --reduced --device cuda --l2s --scheduler --head screened-cuda
    --draft-head screened-cuda``: the launcher serves the dense family on
    the card over a page pool (its ``kv pool`` line) and spec lanes, and
    returns 0. (``[train-dense]`` runs the training launcher on full-width
    gemma-2b, with its 256,000-word corpus.)"""
    import contextlib
    import io

    from repro_torch.launch import serve
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cuda", "--l2s",
            "--scheduler", "--head", "screened-cuda", "--draft-head",
            "screened-cuda", "--budget", "256", "--clusters", "4",
            "--train-steps", "5", "--requests", "6", "--max-new", "8"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    secs = time.perf_counter() - t0
    text = out.getvalue()
    check(rc == 0 and "kv pool" in text and "spec[screened-cuda]" in text,
          f"[serve-cli] gemma-2b: exit code {rc}:\n{text}")
    for ln in text.splitlines():
        log(ln)
    log(f"[serve-cli] python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"exit 0 in {secs:.1f} s")


def phase_dense_kernels(torch, np):
    """[parity] and [timing] at the dense family's new shapes: the route
    (bf16 h) at gemma-2b's d = 2048 and qwen1.5-110b's d = 8192 (float32
    and bf16 h, B in 1, 4, 130; routes equal but near-ties, and a tie
    across the blocks of the thread block cluster to the first index), the
    bf16 gather and fused kernels over gemma's 2,000 tiles at B in 1, 4, 8,
    k in 1, 5, 128 (rtol = atol = 1e-5, fused == unfused bit for bit), the
    gather and fused kernels at d = 8192, and the cache pair at gemma's
    (4, 544, 1, 256), smollm's (.., 5, 64) and starcoder2's (.., 2, 128)
    bf16 rows, bit for bit. Then timing rows in turns under the clean-L2
    timer: route, gather and fused (bf16) at gemma's width, B = 4, K = 16,
    k = 1; the route at d = 8192 (bf16 h); the cache pair at gemma's
    shape. → ({kernel: max abs err}, {kernel: {shape: timing dict}})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    err = {"cluster_route": 0.0, "cluster_route_bf16": 0.0,
           "screened_logits_bf16": 0.0, "fused_screened_topk_bf16": 0.0,
           "cache_slot_update": 0.0}
    near = 0

    def route_check(h, v, name):
        nonlocal near
        route, plain = cluster_route(h, v), cluster_route_plain(h, v)
        scores = h.float() @ v.T
        s_r = scores.gather(1, route.long()[:, None])[:, 0]
        s_p = scores.gather(1, plain.long()[:, None])[:, 0]
        diff = route != plain
        check(bool(((s_r - s_p).abs()[diff] < 1e-5 * s_p.abs()[diff]).all()),
              f"{name} d={h.shape[1]}: routes differ beyond near-ties")
        near += int(diff.sum())
        err[name] = max(err[name], float((s_r - s_p).abs().max()))

    g = torch.Generator(device="cuda").manual_seed(91)
    for d in (GD, QD):
        v = torch.randn((R, d), generator=g, device="cuda")
        for B in (1, 4, 130):
            h = torch.randn((B, d), generator=g, device="cuda")
            route_check(h.bfloat16(), v, "cluster_route_bf16")
            if d == QD:
                route_check(h, v, "cluster_route")
        tv = torch.round(torch.randn((R, d), generator=g, device="cuda") *
                         2) / 2
        tv[3] = tv[50] = tv[99] = 4.0
        th = torch.round(torch.rand((4, d), generator=g, device="cuda") *
                         3) * 0.5 + 0.5
        for hh in (th, th.bfloat16()):
            check(bool((cluster_route(hh, tv) == 3).all()) and
                  bool((cluster_route_plain(hh, tv) == 3).all()),
                  f"cluster_route d={d}: a tie across the blocks of the "
                  f"cluster did not go to the first index")
    W = torch.randn((GV, GD), generator=g, device="cuda") * 0.05
    b = torch.randn((GV,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W.bfloat16(), b.bfloat16())
    del W, b
    n_blk = Wb.shape[0]
    v = torch.randn((R, GD), generator=g, device="cuda")
    cand = torch.from_numpy(make_screen_blocks(np, 92, n_blk)).cuda()
    for B in (1, 4, 8):
        h = torch.randn((B, GD), generator=g, device="cuda").bfloat16()
        ids = cand[cluster_route_plain(h, v).long()].contiguous()
        raw = screened_logits(Wb, bb, h, ids)
        praw = screened_logits_plain(Wb, bb, h, ids)
        torch.testing.assert_close(raw, praw, **TOL)
        err["screened_logits_bf16"] = max(err["screened_logits_bf16"],
                                          float((raw - praw).abs().max()))
        for k in (1, 5, 128):
            fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k)
            pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
            torch.testing.assert_close(fv, pv, **TOL)
            torch.testing.assert_close(fz, pz, **TOL)
            err["fused_screened_topk_bf16"] = max(
                err["fused_screened_topk_bf16"], float((fv - pv).abs().max()))
            ui, uv, _ = unfused_topk(Wb, bb, h, ids, k)
            check(torch.equal(fi, ui) and torch.equal(fv, uv),
                  f"fused bf16 != unfused at gemma's shape (B={B}, k={k})")
    # the gather and fused kernels at d = 8192 (200 tiles)
    Wq = (torch.randn((200 * V_BLK, QD), generator=g, device="cuda") *
          0.05).bfloat16()
    Wqb, bqb = ops.pack_head_blocks(Wq, torch.zeros(200 * V_BLK,
                                                    dtype=torch.bfloat16,
                                                    device="cuda"))
    del Wq
    hq = torch.randn((4, QD), generator=g, device="cuda").bfloat16()
    idq = torch.randint(0, 202, (4, K), generator=g, device="cuda",
                        dtype=torch.int32)
    torch.testing.assert_close(screened_logits(Wqb, bqb, hq, idq),
                               screened_logits_plain(Wqb, bqb, hq, idq),
                               **TOL)
    for k in (1, 5):
        fi, fv, fz = fused_screened_topk(Wqb, bqb, hq, idq, k)
        ui, uv, _ = unfused_topk(Wqb, bqb, hq, idq, k)
        pi, pv, pz = fused_screened_topk_plain(Wqb, bqb, hq, idq, k)
        torch.testing.assert_close(fv, pv, **TOL)
        check(torch.equal(fi, ui) and torch.equal(fv, uv),
              f"fused bf16 != unfused at d={QD} (k={k})")
    del Wqb, bqb
    gc_ = torch.Generator().manual_seed(93)
    for KV_, hd in ((1, 256), (5, 64), (2, 128)):
        ck, cv = (torch.randn((GB, GMAX, KV_, hd), generator=gc_).to(
            "cuda", torch.bfloat16) for _ in range(2))
        uk, uv_ = (torch.randn((GB, KV_, hd), generator=gc_).to(
            "cuda", torch.bfloat16) for _ in range(2))
        for slot in (0, GMAX - 1, GMAX + 3,
                     torch.tensor([5, 511, GMAX + 2, -1], dtype=torch.int32,
                                  device="cuda")):
            gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv_, slot)
            check(torch.equal(gk, cache_slot_update_plain(ck.clone(), uk,
                                                          slot)) and
                  torch.equal(gv, cache_slot_update_plain(cv.clone(), uv_,
                                                          slot)),
                  f"cache_kv_update at (KV, hd) = ({KV_}, {hd}) bf16: not "
                  f"bit for bit")
    log(f"[parity] dense shapes: route at d={GD} (bf16 h) and d={QD} "
        f"(float32 and bf16 h), B in 1, 4, 130, == plain but near-ties "
        f"({near}), a tie across the blocks of the cluster to the first "
        f"index at both widths; bf16 gather and fused over gemma-2b's "
        f"{n_blk} tiles, B in 1, 4, 8, k in 1, 5, 128 (rtol=atol=1e-5), fused "
        f"== unfused bit for bit; gather and fused at d={QD}; the cache pair "
        f"bit for bit at (KV, hd) = (1, 256), (5, 64), (2, 128) bf16, "
        f"S={GMAX}; max abs err {json.dumps(err)}")

    timer = Timer(torch)
    rows = {}
    gem = l2s_rows(torch, np, timer, Wb, bb, v, cand, GB, 1, 94)
    for name, row in gem.items():
        rows.setdefault(name, {})["at_gemma_width"] = row
    del Wb, bb
    vq = torch.randn((R, QD), generator=g, device="cuda")
    hq = torch.randn((GB, QD), generator=g, device="cuda").bfloat16()
    t = timer.turns({"library_ms": lambda: torch.argmax(hq.float() @ vq.T,
                                                        dim=-1),
                     "ms": lambda: cluster_route(hq, vq),
                     "plain_ms": lambda: cluster_route_plain(hq, vq)})
    t["bound"] = bound_ms(2 * GB * QD + 4 * (R * QD + GB), 2 * GB * R * QD)
    rows["cluster_route_bf16"]["at_qwen_width"] = t
    log(f"[timing] torch.bfloat16 d={QD} B={GB} cluster_route_bf16 (4 rows "
        f"of h a cluster): {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
        f"library {t['library_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
        f"({t['bound'][1]})")
    ck, cv = (torch.zeros((GB, GMAX, 1, 256), dtype=torch.bfloat16,
                          device="cuda") for _ in range(2))
    uk, uv_ = (torch.randn((GB, 1, 256), device="cuda").bfloat16()
               for _ in range(2))
    slots = torch.tensor([GT] * GB, dtype=torch.int32, device="cuda")
    rows_idx = torch.arange(GB, device="cuda")

    def library():
        ck[rows_idx, slots.long()] = uk
        cv[rows_idx, slots.long()] = uv_
    t = timer.turns({"library_ms": library,
                     "ms": lambda: cache_kv_update(ck, uk, cv, uv_, slots),
                     "plain_ms": lambda: (
                         cache_slot_update_plain(ck, uk, slots),
                         cache_slot_update_plain(cv, uv_, slots))})
    t["bound"] = bound_ms(2 * 2 * 2 * GB * 256, 0)
    rows["cache_slot_update"] = {"at_gemma_cache": t}
    log(f"[timing] torch.bfloat16 cache_kv_update (K and V) at gemma-2b's "
        f"({GB}, {GMAX}, 1, 256): {t['ms']:.5f} ms, plain "
        f"{t['plain_ms']:.5f} ms, library (indexed writes, twice) "
        f"{t['library_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
        f"({t['bound'][1]})")
    return err, rows


# -- the moe family: mixtral-8x7b (a 4,096-slot ring), phi3.5-moe ---------------
# mixtral-8x7b (arXiv 2401.04088) in its config's bfloat16 at full widths
# (d = 4096, 32 heads, kv 8, 8 experts top-2 of d_ff = 14,336, V = 32,000,
# untied, window 4,096) cut to 8 of 32 layers (32 do not fit one card);
# 4 prompts of 512, 32 new (its ring holds 4,096 slots whatever max_len is)
XD, XV, X_LAYERS = 4096, 32_000, 8
XB, XT, XNEW, XMAX = 4, 512, 32, 544
XWIN = 4096
XRING_T, XRING_NEW = 4000, 240       # wraps the ring by 144 positions
XSPEC_T, XSPEC_NEW = 4080, 32        # spec drafts cross the wrap
XSPEC_MAX = 4160
XF32_LAYERS = 2                      # the float32 ring check's depth
# phi3.5-moe-42b-a6.6b (hf:microsoft/Phi-3.5-MoE-instruct) at full widths
# (16 experts of d_ff = 6,400, layernorm, V = 32,064: 251 tiles, the last
# holding 64 words) cut to 2 of 32 layers
PV, P_LAYERS = 32_064, 2
PMAX, PPAGE = 128, 16                # phi's paged stream: 8 pages of 16


def phase_moe_kernels(torch, np):
    """[parity] and [timing] at the moe family's shapes: the route (bf16 h)
    at d = 4096, B in 1, 4, 130 (routes equal but near-ties) with a tie
    across the blocks of its thread block cluster; the bf16 gather and
    fused kernels over mixtral's 250 tiles and phi's 251 (the last tile
    64 real words, in every row), B in 1, 4, 8, k in 1, 5, 128 (rtol = atol
    = 1e-5; fused == unfused bit for bit; no padded word in a top-k); the
    cache pair at mixtral's ring (4, 4096, 8, 128) bf16 at per-row slots
    pos % 4096 of positions that wrap, bit for bit. Timing rows in turns
    under the clean-L2 timer: route, gather and fused (bf16) at mixtral's
    width (B = 4, K = 16, k = 1), gather and fused over phi's tiles, the
    cache pair at the ring's shape.
    → ({kernel: max abs err}, {kernel: {shape: timing dict}})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    err = {k: 0.0 for k in BF16_KERNELS + ("cache_slot_update",)}
    near = 0
    g = torch.Generator(device="cuda").manual_seed(95)
    v = torch.randn((R, XD), generator=g, device="cuda")
    for B in (1, 4, 130):
        h = torch.randn((B, XD), generator=g, device="cuda").bfloat16()
        route, plain = cluster_route(h, v), cluster_route_plain(h, v)
        scores = h.float() @ v.T
        s_r = scores.gather(1, route.long()[:, None])[:, 0]
        s_p = scores.gather(1, plain.long()[:, None])[:, 0]
        diff = route != plain
        check(bool(((s_r - s_p).abs()[diff] < 1e-5 * s_p.abs()[diff]).all()),
              f"cluster_route_bf16 d={XD}: routes differ beyond near-ties")
        near += int(diff.sum())
        err["cluster_route_bf16"] = max(err["cluster_route_bf16"],
                                        float((s_r - s_p).abs().max()))
    tv = torch.round(torch.randn((R, XD), generator=g, device="cuda") * 2) / 2
    tv[3] = tv[50] = tv[99] = 4.0
    th = (torch.round(torch.rand((4, XD), generator=g, device="cuda") * 3) *
          0.5 + 0.5).bfloat16()
    check(bool((cluster_route(th, tv) == 3).all()) and
          bool((cluster_route_plain(th, tv) == 3).all()),
          f"cluster_route_bf16 d={XD}: a tie across the blocks of the cluster "
          f"did not go to the first index")
    heads = {}
    for L in (XV, PV):
        W = torch.randn((L, XD), generator=g, device="cuda") * 0.05
        b = torch.randn((L,), generator=g, device="cuda") * 0.1
        Wb, bb = ops.pack_head_blocks(W.bfloat16(), b.bfloat16())
        del W, b
        n_blk = Wb.shape[0]
        heads[L] = (Wb, bb)
        for B in (1, 4, 8):
            h = torch.randn((B, XD), generator=g, device="cuda").bfloat16()
            ids = torch.randint(0, n_blk + 2, (B, K), generator=g,
                                device="cuda", dtype=torch.int32)
            ids[:, 1] = n_blk - 1                  # the last (partial) tile
            raw = screened_logits(Wb, bb, h, ids)
            praw = screened_logits_plain(Wb, bb, h, ids)
            torch.testing.assert_close(raw, praw, **TOL)
            err["screened_logits_bf16"] = max(err["screened_logits_bf16"],
                                              float((raw - praw).abs().max()))
            for k in (1, 5, 128):
                fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k)
                pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
                torch.testing.assert_close(fv, pv, **TOL)
                torch.testing.assert_close(fz, pz, **TOL)
                err["fused_screened_topk_bf16"] = max(
                    err["fused_screened_topk_bf16"],
                    float((fv - pv).abs().max()))
                ui, uv, _ = unfused_topk(Wb, bb, h, ids, k)
                check(torch.equal(fi, ui) and torch.equal(fv, uv) and
                      bool((fi < L).all()),
                      f"fused bf16 != unfused (or a padded word) over "
                      f"{n_blk} tiles (B={B}, k={k})")
    gc_ = torch.Generator().manual_seed(96)
    ck, cv = (torch.randn((XB, XWIN, 8, 128), generator=gc_).to(
        "cuda", torch.bfloat16) for _ in range(2))
    uk, uv_ = (torch.randn((XB, 8, 128), generator=gc_).to(
        "cuda", torch.bfloat16) for _ in range(2))
    for pos in ((4095, 4096, 8191, 5000), (0, 1, 4097, 12287)):
        slot = torch.remainder(torch.tensor(pos, dtype=torch.int32,
                                            device="cuda"), XWIN)
        gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv_, slot)
        check(torch.equal(gk, cache_slot_update_plain(ck.clone(), uk,
                                                      slot)) and
              torch.equal(gv, cache_slot_update_plain(cv.clone(), uv_, slot)),
              f"cache_kv_update at ring slots pos % {XWIN} {pos}: not bit "
              f"for bit")
    log(f"[parity] moe shapes: route bf16 h at d={XD}, B in 1, 4, 130, == "
        f"plain but near-ties ({near}), a tie across the blocks of the "
        f"cluster to the first index; bf16 gather and fused at d={XD} over "
        f"mixtral-8x7b's {heads[XV][0].shape[0]} tiles and phi3.5-moe's "
        f"{heads[PV][0].shape[0]} (the last tile {PV % V_BLK} words, in every "
        f"row), B in 1, 4, 8, k in 1, 5, 128 (rtol=atol=1e-5), fused == "
        f"unfused bit for bit, no padded word in a top-k; the cache pair bit "
        f"for bit at mixtral's ring ({XB}, {XWIN}, 8, 128) bf16, per-row "
        f"slots pos % {XWIN} of positions that wrap; max abs err "
        f"{json.dumps(err)}")

    timer = Timer(torch)
    rows = {}
    cand = torch.from_numpy(make_screen_blocks(np, 97, XV // V_BLK)).cuda()
    for name, row in l2s_rows(torch, np, timer, *heads[XV], v, cand, XB, 1,
                              98).items():
        rows.setdefault(name, {})["at_mixtral_width"] = row
    cand = torch.from_numpy(make_screen_blocks(np, 99, -(-PV // V_BLK))).cuda()
    cand[::2, 0] = PV // V_BLK                      # the partial tile
    for name, row in l2s_rows(torch, np, timer, *heads[PV], v, cand, XB, 1,
                              100).items():
        if name != "cluster_route_bf16":
            rows.setdefault(name, {})["at_phi_tiles"] = row
    del heads
    slots = torch.remainder(torch.tensor([4095, 4096, 8191, 5000],
                                         dtype=torch.int32, device="cuda"),
                            XWIN)
    rows_idx = torch.arange(XB, device="cuda")

    def library():
        ck[rows_idx, slots.long()] = uk
        cv[rows_idx, slots.long()] = uv_
    t = timer.turns({"library_ms": library,
                     "ms": lambda: cache_kv_update(ck, uk, cv, uv_, slots),
                     "plain_ms": lambda: (
                         cache_slot_update_plain(ck, uk, slots),
                         cache_slot_update_plain(cv, uv_, slots))})
    t["bound"] = bound_ms(2 * 2 * 2 * XB * 8 * 128, 0)
    rows["cache_slot_update"] = {"at_mixtral_ring": t}
    log(f"[timing] torch.bfloat16 cache_kv_update (K and V) at mixtral-8x7b's "
        f"ring ({XB}, {XWIN}, 8, 128), wrapped per-row slots: "
        f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, library (indexed "
        f"writes, twice) {t['library_ms']:.5f} ms, bound {t['bound'][0]:.7f} "
        f"ms ({t['bound'][1]})")
    return err, rows


def phase_moe_ring_f32(torch, np):
    """[moe] mixtral-8x7b at full widths cut to 2 layers, drawn in float32 with a
    capacity that drops no slot (cf = E / k = 4, so no token's output
    depends on another's and a prefill's routing equals a decode's): a
    prefill of 4,000 tokens and 240 decode steps through the 4,096-slot
    ring (wrapping it by 144) against one windowed forward over the
    4,240 tokens. The tolerance: max |h_dec - h_fwd| <= 1e-4 x max
    |h_fwd| (float32, TF32 off: the GEMVs and GEMMs sum in other orders).
    → the max relative error."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    t0 = time.perf_counter()
    base = get_config("mixtral-8x7b")
    cfg = replace(base, num_layers=XF32_LAYERS,
                  moe=replace(base.moe, capacity_factor=base.moe.num_experts
                              / base.moe.top_k))
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(7),
                        device="cuda", dtype=torch.float32)
    n = XRING_T + XRING_NEW
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, XV, (1, n)),
                           device="cuda")
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(1, 16, dtype=torch.float32, device="cuda")
        check(cache["attn"]["k"].shape[2] == XWIN,
              "mixtral-8x7b: its cache is not a ring of its window")
        model.prefill(params, {"tokens": toks[:, :XRING_T]}, cache)
        hs = [model.decode_step(params, toks[:, i], cache, i)[0]
              for i in range(XRING_T, n)]
        dec = torch.stack(hs, 1)
        want = full[:, XRING_T:]
        rel = float((dec - want).abs().max() / want.abs().max())
    check(rel <= 1e-4, f"[moe] mixtral-8x7b float32 ring decode against the "
          f"windowed forward: max relative error {rel:.3g} > 1e-4")
    del params, full, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] mixtral-8x7b float32, full widths, {XF32_LAYERS} layers, "
        f"capacity factor {cfg.moe.capacity_factor:.1f} (no slot dropped): "
        f"prefill {XRING_T} + {XRING_NEW} decode steps through the "
        f"{XWIN}-slot ring against one windowed forward over {n} tokens: max "
        f"relative error of the hidden states {rel:.3g} (<= 1e-4), "
        f"{time.perf_counter() - t0:.1f} s")
    return rel


def phase_moe_mixtral(torch, np):
    """[moe] mixtral-8x7b at full widths cut to 8 layers in its config's
    bfloat16 (11.9 B parameters drawn on the card): the runs of
    ``serve_bf16`` at 4 x 512 + 32 (exact, the plain screened head,
    screened-cuda fused and unfused, beam 4, sampled, a full cover of its
    250 tiles, graphs == eager bodies, profiles, the step's weight-read
    bound: every expert is read each step); then a ring run: 2 prompts of
    4,000 tokens (the chunked attention path), 240 new through
    screened-cuda, wrapping the 4,096-slot ring by 144 positions (8 cache
    pairs a step), held to the plain screened head under the bf16 gap
    rule. → ({path: launches}, the model dict)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine
    t_phase = time.perf_counter()
    g = dense_model(torch, np, "mixtral-8x7b", "[moe]", layers=X_LAYERS,
                    seed=5, full=True)
    cfg = g["model"].cfg
    check((cfg.d_model, cfg.vocab_size, cfg.moe.num_experts,
           cfg.sliding_window, cfg.num_layers) == (XD, XV, 8, XWIN, X_LAYERS),
          "mixtral-8x7b: config drifted from the smoke's shapes")
    prompts = g["rng"].integers(0, XV, (XB, XT))
    paths = {"mixtral-8x7b bf16": serve_bf16(torch, np, "[moe]", g, prompts,
                                             XNEW, XMAX)}
    model, params = g["model"], g["params"]
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=XMAX,
                       cache_dtype=torch.bfloat16, device="cuda")
    long_p = g["rng"].integers(0, XV, (2, XRING_T))
    eng.generate(long_p[:, :16], 2, head="screened-cuda")      # warm-up
    acc = {}
    ring, t_ring = counted(torch, acc, lambda: host_timed(
        torch, lambda: eng.generate(long_p, XRING_NEW,
                                    head="screened-cuda")))
    check(ring.tokens.shape == (2, XRING_NEW) and ring.tokens.min() >= 0 and
          ring.tokens.max() < XV, "[moe] mixtral-8x7b ring run: tokens out of "
          "range")
    check(acc["cache_slot_update"] == X_LAYERS * (XRING_NEW - 1) and
          acc["cluster_route_bf16"] == acc["fused_screened_topk_bf16"] ==
          XRING_NEW and not any(acc[k] for k in L2S_KERNELS),
          f"[moe] mixtral-8x7b ring run: launches {acc}")
    plain = eng.generate(long_p, XRING_NEW, head="screened")
    near = bf16_gap_rule(torch, np, "[moe] mixtral-8x7b ring run", model,
                         params, long_p, ring.tokens, plain.tokens, XMAX,
                         screened_gap_fn(torch, eng))
    paths["mixtral-8x7b ring"] = acc
    log(f"[moe] mixtral-8x7b ring run: 2 prompts of {XRING_T} tokens "
        f"(chunked attention prefill), {XRING_NEW} new through screened-cuda "
        f"in {t_ring:.3f} s ({2 * XRING_NEW / t_ring:.1f} tok/s, host clock), "
        f"positions up to {XRING_T + XRING_NEW - 1}: the {XWIN}-slot ring "
        f"wrapped by {XRING_T + XRING_NEW - XWIN} positions; == the plain "
        f"screened head's tokens except rows first differing after a step "
        f"with a gap < {GAP_BF16}: {near}; launches (from zero): "
        f"{json.dumps(acc)}")
    del eng
    log(f"[moe] mixtral-8x7b phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths, g


def phase_moe_spec(torch, np, g):
    """[moe] mixtral-8x7b spec: a width-4 SpecDecodeStream (draft
    screened-cuda on the random screen, verify exact, draft_len 4) over 4
    prompts of 4,080 tokens, 32 new: its rounds draft across the ring's
    wrap at 4,096, so rejected rows come back from the snapshot ring, which
    holds the ring K/V caches whole (as the reference's snapshots do);
    tokens == a plain width-4 exact stream under the bf16 gap rule,
    rejections > 0, rows restored > 0; the ring's MiB and a slot's copy
    time. → launches of the spec run."""
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params = g["model"], g["params"]
    t_phase = time.perf_counter()
    eng = DecodeEngine(model, params, screen=g["screen"], max_len=XSPEC_MAX,
                       cache_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(33)
    prompts = rng.integers(0, XV, (DENSE_W, XSPEC_T))
    reqs = [ServeRequest(prompt=p, max_new=XSPEC_NEW) for p in prompts]
    plan = [0] * len(reqs)
    plain, _, _, plain_s = drive_stream(eng.open_stream("exact",
                                                        width=DENSE_W),
                                        reqs, plan)
    acc = {}
    s = eng.open_spec_stream("screened-cuda", "exact", width=DENSE_W,
                             draft_len=SPEC_N)
    t0 = time.perf_counter()
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        s, reqs, plan))
    wall = time.perf_counter() - t0
    near = bf16_gap_rule(torch, np, "[moe] mixtral-8x7b spec", model, params,
                         prompts, np.stack([got[i] for i in range(len(reqs))]),
                         np.stack([plain[i] for i in range(len(reqs))]),
                         XSPEC_MAX, exact_gap_fn(torch, eng))
    c = s.spec_counters()
    check(c["drafted"] - c["accepted"] > 0 and s.restored_rows > 0 and
          s._snapshot,
          f"[moe] mixtral-8x7b spec: no draft rejected and rolled back: {c}, "
          f"{s.restored_rows} rows restored")
    slab = eng._lend_stream_slab(DENSE_W, s._slab_key(), spec_depth=SPEC_N)
    ring = slab.spec.ring_nbytes
    check(len(slab.spec.ring) == 2 and
          slab.spec.ring[0].shape[3] == XWIN,
          f"[moe] mixtral-8x7b spec: the snapshot ring does not hold the "
          f"ring K/V caches: {[tuple(r.shape) for r in slab.spec.ring]}")
    with torch.inference_mode():
        copy = Timer(torch, reps=5)(lambda: slab.spec.snapshot(slab.cache,
                                                               0))
    eng._return_stream_slab(slab)
    log(f"[moe] mixtral-8x7b spec: SpecDecodeStream width {DENSE_W}, draft "
        f"screened-cuda (random screen), verify exact, draft_len {SPEC_N}, "
        f"{len(reqs)} prompts of {XSPEC_T}, {XSPEC_NEW} new (positions "
        f"{XSPEC_T}..{XSPEC_T + XSPEC_NEW + SPEC_N - 2}: drafts cross the "
        f"wrap at {XWIN}): tokens == a plain width-{DENSE_W} exact stream "
        f"except rows first differing after a step with a gap < {GAP_BF16}: "
        f"{near}; {spec_summary(s, step_s)}; snapshot ring "
        f"{ring / 2 ** 20:.1f} MiB (the ring K/V caches, {SPEC_N} slots), "
        f"one slot's copy {copy:.4f} ms (CUDA events); {ticks} rounds in "
        f"{wall:.3f} s against the plain stream's {len(plain_s)} steps at "
        f"median {statistics.median(plain_s) * 1e3:.3f} ms (host clock); "
        f"launches of the run (from zero): {json.dumps(acc)}")
    log(f"[moe] mixtral-8x7b spec phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return acc


def moe_traffic(np, vocab, n=8):
    """[moe] phi paged's requests: 2 prompts of 64 tokens, each with a
    distinct suffix of 32 (prompts of one length, 96), 16 new."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(34)
    bases = rng.integers(0, vocab, (2, 64))
    return [ServeRequest(prompt=np.concatenate(
        [bases[i % 2], rng.integers(0, vocab, 32)]), max_new=16)
        for i in range(n)]


def phase_moe_phi(torch, np):
    """[moe] phi3.5-moe at full widths cut to 2 layers in bf16 (layernorm,
    16 experts, 251 tiles): greedy 4 x 128 + 16 through exact,
    screened-cuda and the plain head (``dense_greedy``); a width-4
    PagedDecodeStream (pages of 16) over 8 requests sharing 2 prompts ==
    a plain width-4 stream bit for bit (prompts of one length), both
    screened-cuda, the paged run with no cache-pair launch.
    → {path: launches}."""
    from repro_torch.serving import DecodeEngine, PagePool
    p = dense_model(torch, np, "phi3.5-moe-42b-a6.6b", "[moe]",
                    layers=P_LAYERS, seed=6)
    cfg = p["model"].cfg
    check((cfg.d_model, cfg.vocab_size, cfg.moe.num_experts, cfg.norm) ==
          (XD, PV, 16, "layernorm") and cfg.sliding_window is None,
          "phi3.5-moe: config drifted from the smoke's shapes")
    out = {"phi3.5-moe bf16": dense_greedy(torch, np, "[moe] phi3.5-moe", p,
                                           128, 16, 144)}
    eng = DecodeEngine(p["model"], p["params"], screen=p["screen"],
                       max_len=PMAX, cache_dtype=torch.bfloat16,
                       device="cuda")
    reqs = moe_traffic(np, PV)
    plan = [0] * len(reqs)
    head = "screened-cuda"
    plain, _, _, plain_s = drive_stream(eng.open_stream(head, width=DENSE_W),
                                        reqs, plan)
    acc = {}
    pool = PagePool(128, PPAGE)
    got, ticks, _, step_s = counted(torch, acc, lambda: drive_stream(
        eng.open_paged_stream(pool, head=head, width=DENSE_W), reqs, plan))
    check(all(np.array_equal(got[i], plain[i]) for i in plain),
          "[moe] phi3.5-moe paged tokens differ from the plain stream's")
    rx = pool.radix.telemetry()
    check(rx["tokens_hit"] > 0 and acc["cache_slot_update"] == 0 and
          acc["fused_screened_topk_bf16"] > 0,
          f"[moe] phi3.5-moe paged: radix {rx}, launches {acc}")
    log(f"[moe] phi3.5-moe paged: PagedDecodeStream width {DENSE_W}, page "
        f"{PPAGE}, {len(reqs)} requests on 2 shared prompts of 64 tokens "
        f"(+ 32 distinct), 16 new: tokens == a plain width-{DENSE_W} {head} "
        f"stream bit for bit; prompt tokens on shared pages "
        f"{rx['tokens_hit']} of {rx['tokens_total']}, store "
        f"{pool.store.nbytes / 2 ** 20:.1f} MiB; paged step median "
        f"{statistics.median(step_s) * 1e3:.3f} ms over {ticks} ticks, plain "
        f"{statistics.median(plain_s) * 1e3:.3f} ms (host clock); launches "
        f"(from zero): {json.dumps(acc)}")
    out["phi3.5-moe paged"] = acc
    del p, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def card_vs_cpu_grads(torch, np, tag, cfg, T, seed):
    """loss_and_grads of ``cfg`` (float32, drawn on the card) on 1 x T
    random tokens (vlm: after its patches; audio: T random frames), on the
    card and on the CPU: every leaf within 1e-4 x max |g|, the loss within
    1e-5 relative. → a log line's text."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.tree import tree_flatten
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, T + 1)))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    if cfg.family == "vlm":          # the text's T tokens after P patches
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32))
    elif cfg.family == "audio":      # T frames and their unit labels
        batch = {"frames": torch.as_tensor(rng.standard_normal(
                    (1, T, cfg.d_model)).astype(np.float32)),
                 "labels": batch["labels"] % cfg.vocab_size}
    tcfg = TrainConfig(remat="none", loss_chunk=None)
    side = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params if where == "cuda" else to_device(params, "cpu")
        loss, grads = loss_and_grads(model, tcfg, p,
                                     {k: x.to(where) for k, x in batch.items()})
        side[where] = (float(loss), [x.cpu() for x in tree_flatten(grads)],
                       time.perf_counter() - t0)
        del grads, p
    gerr, gmax = grads_close(torch, f"{tag} card vs CPU", side["cuda"][1],
                             side["cpu"][1])
    lrel = abs(side["cuda"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    check(lrel <= 1e-5, f"{tag} card vs CPU loss rel {lrel:.3g}")
    del params, side
    gc.collect()
    torch.cuda.empty_cache()
    return (f"loss_and_grads on the card vs the CPU: max |g_card - g_cpu| "
            f"{gerr:.3g} <= 1e-4 x max |g| {gmax:.3g}; loss rel {lrel:.2g} "
            f"<= 1e-5")


def phase_train_dense(torch, np):
    """[train-dense] ``python -m repro_torch.launch.train --arch gemma-2b
    --steps 2 --batch 4 --seq 512`` at full width in float32 (weights from
    a CPU generator, the 256,000-word corpus built on the host: its build
    time printed; s/step; peak device memory), then gemma-2b cut to 2
    layers, card against CPU gradients at 1 x 256. → {path: launches}."""
    import contextlib
    import io
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    argv = ["--arch", "gemma-2b", "--device", "cuda", "--steps", "2",
            "--batch", "4", "--seq", "512", "--log-every", "1"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(ops.LAUNCHES)
    text = out.getvalue()
    corpus = [ln for ln in text.splitlines() if "[train] corpus" in ln]
    check(rc == 0 and text.count("[train] step") == 2 and corpus,
          f"[train-dense] launch.train gemma-2b: exit {rc}:\n{text}")
    build_s = float(corpus[0].split(" built in ")[1].split(" s")[0])
    check(build_s <= 60.0, f"[train-dense] the 256,000-word corpus took "
          f"{build_s:.1f} s > 60 s")
    for ln in text.splitlines():
        log(ln)
    log(f"[train-dense] python -m repro_torch.launch.train {' '.join(argv)}: "
        f"exit 0 in {secs:.1f} s (full-width gemma-2b, 2.51 B float32 "
        f"parameters, remat none); corpus build {build_s:.1f} s on the host "
        f"(<= 60 s); peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = replace(get_config("gemma-2b"), num_layers=2)
    text = card_vs_cpu_grads(torch, np, "[train-dense] gemma-2b 2 layers",
                             cfg, 256, 62)
    log(f"[train-dense] gemma-2b full width, 2 layers, 1 x 256: {text}; phase "
        f"wall {time.perf_counter() - t_phase:.1f} s")
    return {"gemma-2b train": launches}


def phase_train_moe(torch, np):
    """[train-moe] mixtral-8x7b at full widths cut to 2 layers in float32:
    ``make_train_step(..., donate=True)``, remat none, 2 steps of 4 x 512
    (loss, gnorm, s/step, peak device memory; the aux loss finite, > 0 and
    in the loss: loss == cross-entropy + aux within 1e-5); then 1 layer,
    card against CPU gradients at 1 x 128. → {path: launches}."""
    from dataclasses import replace

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.lm import cross_entropy_loss
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base = get_config("mixtral-8x7b")
    cfg = replace(base, num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(72),
                        device="cuda", dtype=torch.float32)
    n_params = sum(t.numel() for t in tree_flatten(params))
    toks = torch.as_tensor(np.random.default_rng(72).integers(
        0, XV, (TRAIN_SSM_B, TRAIN_SSM_T + 1)), device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    with torch.inference_mode():
        h, aux = model.forward(params, batch)
        xent = cross_entropy_loss(model.logits(params, h), batch["labels"])
        aux, xent = float(aux), float(xent)
        del h
    tcfg = TrainConfig(lr=5e-4, warmup_steps=1, total_steps=10,
                       remat="none", loss_chunk=None)
    step = make_train_step(model, tcfg, donate=True)
    opt = adamw_init(params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, gnorms, secs = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(np.isfinite(aux) and aux > 0 and
          abs(losses[0] - (xent + aux)) <= 1e-5 * abs(losses[0]),
          f"[train-moe] the aux loss {aux} is not in the first step's loss "
          f"{losses[0]} (cross-entropy {xent})")
    check(all(np.isfinite(losses + gnorms)) and losses[1] < losses[0] and
          peak < 80.0, f"[train-moe] losses {losses}, gnorms {gnorms}, peak "
          f"{peak:.2f} GiB")
    log(f"[train-moe] mixtral-8x7b full widths, 2 of 32 layers "
        f"({n_params} float32 parameters), make_train_step(donate=True), "
        f"remat none, 2 steps of {TRAIN_SSM_B} x {TRAIN_SSM_T}: loss "
        f"{', '.join(f'{x:.4f}' for x in losses)} (the first = cross-entropy "
        f"{xent:.6f} + aux {aux:.6f}), gnorm "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}; s/step "
        f"{', '.join(f'{x:.3f}' for x in secs)} (host clock, each ending in a "
        f"sync; the first pays first-use costs); peak device memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    del params, opt, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    text = card_vs_cpu_grads(torch, np, "[train-moe] mixtral-8x7b 1 layer",
                             replace(base, num_layers=1), 128, 73)
    log(f"[train-moe] mixtral-8x7b full widths, 1 layer, 1 x 128: {text}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"mixtral-8x7b train": launches}


# -- the vlm and audio families: qwen2-vl-2b, hubert-xlarge ---------------------
# qwen2-vl-2b (arXiv 2409.12191) in its config's bfloat16 at full width (28
# layers, d = 1536, 12 heads, kv 2, hd 128, SwiGLU d_ff = 8,960, qkv bias,
# M-RoPE, V = 151,936: 1,187 tiles, tied) with 256 patch embeddings (a
# 16 x 16 grid): 4 prompts of 256 patches + 256 tokens, 32 new; its cache
# holds the patches too (256 + 256 + 32 = 544 slots)
VD, VV, VP = 1536, 151_936, 256
VB, VT, VNEW = 4, 256, 32
VMAX = VP + VT + VNEW
VCPU_B, VCPU_T, VCPU_NEW = 2, 64, 9  # [vlm] card vs CPU: 8 decode steps
# the profiled vlm runs are eager (~2,300 host ops a step), so the
# profiler's host events grow fast: profile 4 tokens, and 4 steps alone
VPROF = 4
# hubert-xlarge (arXiv 2106.07447) at full width (48 layers, d = 1280, 16
# heads, MHA, gelu d_ff = 5,120, layernorm, 504 units), bf16 weights and
# float32 frames: 4 x 1,024 frames, then one of 2,048 (the chunked path)
HD, HB, HT, HLONG = 1280, 4, 1024, 2048


def phase_vlm_kernels(torch, np):
    """[parity] and [timing] at qwen2-vl-2b's shapes: the route (bf16 h,
    float32 v) at d = 1536, B in 1, 4 (routes equal but near-ties) with a
    tie across the blocks of its thread block cluster; the bf16 gather and
    fused kernels over its 1,187 tiles, B in 1, 4, k in 1, 5, 128 (rtol =
    atol = 1e-5; fused == unfused bit for bit); the cache pair at its
    decode cache (4, 544, 2, 128) bf16, bit for bit. Timing rows in turns
    under the clean-L2 timer: route, gather and fused (bf16) at its width
    (B = 4, K = 16, k = 1) and the cache pair at its cache.
    → ({kernel: max abs err}, {kernel: {shape: timing dict}})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    err = {k: 0.0 for k in BF16_KERNELS + ("cache_slot_update",)}
    near = 0
    g = torch.Generator(device="cuda").manual_seed(101)
    v = torch.randn((R, VD), generator=g, device="cuda")
    for B in (1, 4):
        h = torch.randn((B, VD), generator=g, device="cuda").bfloat16()
        route, plain = cluster_route(h, v), cluster_route_plain(h, v)
        scores = h.float() @ v.T
        s_r = scores.gather(1, route.long()[:, None])[:, 0]
        s_p = scores.gather(1, plain.long()[:, None])[:, 0]
        diff = route != plain
        check(bool(((s_r - s_p).abs()[diff] < 1e-5 * s_p.abs()[diff]).all()),
              f"cluster_route_bf16 d={VD}: routes differ beyond near-ties")
        near += int(diff.sum())
        err["cluster_route_bf16"] = max(err["cluster_route_bf16"],
                                        float((s_r - s_p).abs().max()))
    tv = torch.round(torch.randn((R, VD), generator=g, device="cuda") * 2) / 2
    tv[3] = tv[50] = tv[99] = 4.0
    th = (torch.round(torch.rand((4, VD), generator=g, device="cuda") * 3) *
          0.5 + 0.5).bfloat16()
    check(bool((cluster_route(th, tv) == 3).all()) and
          bool((cluster_route_plain(th, tv) == 3).all()),
          f"cluster_route_bf16 d={VD}: a tie across the blocks of the cluster "
          f"did not go to the first index")
    W = torch.randn((VV, VD), generator=g, device="cuda") * 0.05
    b = torch.randn((VV,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W.bfloat16(), b.bfloat16())
    del W, b
    n_blk = Wb.shape[0]
    check(n_blk == VV // V_BLK == 1187, f"qwen2-vl-2b: {n_blk} tiles")
    cand = torch.from_numpy(make_screen_blocks(np, 102, n_blk)).cuda()
    for B in (1, 4):
        h = torch.randn((B, VD), generator=g, device="cuda").bfloat16()
        ids = cand[cluster_route_plain(h, v).long()].contiguous()
        raw = screened_logits(Wb, bb, h, ids)
        praw = screened_logits_plain(Wb, bb, h, ids)
        torch.testing.assert_close(raw, praw, **TOL)
        err["screened_logits_bf16"] = max(err["screened_logits_bf16"],
                                          float((raw - praw).abs().max()))
        for k in (1, 5, 128):
            fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k)
            pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
            torch.testing.assert_close(fv, pv, **TOL)
            torch.testing.assert_close(fz, pz, **TOL)
            err["fused_screened_topk_bf16"] = max(
                err["fused_screened_topk_bf16"], float((fv - pv).abs().max()))
            ui, uv, _ = unfused_topk(Wb, bb, h, ids, k)
            check(torch.equal(fi, ui) and torch.equal(fv, uv),
                  f"fused bf16 != unfused over qwen2-vl-2b's tiles (B={B}, "
                  f"k={k})")
    gc_ = torch.Generator().manual_seed(103)
    ck, cv = (torch.randn((VB, VMAX, 2, 128), generator=gc_).to(
        "cuda", torch.bfloat16) for _ in range(2))
    uk, uv_ = (torch.randn((VB, 2, 128), generator=gc_).to(
        "cuda", torch.bfloat16) for _ in range(2))
    for slot in (0, VP + VT, VMAX - 1, VMAX + 3,
                 torch.tensor([VP + VT, VP + VT + 7, VMAX - 1, 0],
                              dtype=torch.int32, device="cuda")):
        gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv_, slot)
        check(torch.equal(gk, cache_slot_update_plain(ck.clone(), uk,
                                                      slot)) and
              torch.equal(gv, cache_slot_update_plain(cv.clone(), uv_, slot)),
              f"cache_kv_update at qwen2-vl-2b's cache ({VB}, {VMAX}, 2, "
              f"128) bf16, slot {slot}: not bit for bit")
    log(f"[parity] qwen2-vl-2b shapes: route bf16 h at d={VD}, B in 1, 4, == "
        f"plain but near-ties ({near}), a tie across the blocks of the "
        f"cluster to the first index; bf16 gather and fused at d={VD} over "
        f"its {n_blk} tiles, B in 1, 4, k in 1, 5, 128 (rtol=atol=1e-5), "
        f"fused == unfused bit for bit; the cache pair bit for bit at "
        f"({VB}, {VMAX}, 2, 128) bf16, slots 0, {VP + VT}, {VMAX - 1}, "
        f"{VMAX + 3} (clamped) and per-row; max abs err {json.dumps(err)}")

    timer = Timer(torch)
    rows = {}
    for name, row in l2s_rows(torch, np, timer, Wb, bb, v, cand, VB, 1,
                              104).items():
        rows.setdefault(name, {})["at_qwen2vl_width"] = row
    del Wb, bb
    slots = torch.tensor([VP + VT] * VB, dtype=torch.int32, device="cuda")
    rows_idx = torch.arange(VB, device="cuda")

    def library():
        ck[rows_idx, slots.long()] = uk
        cv[rows_idx, slots.long()] = uv_
    t = timer.turns({"library_ms": library,
                     "ms": lambda: cache_kv_update(ck, uk, cv, uv_, slots),
                     "plain_ms": lambda: (
                         cache_slot_update_plain(ck, uk, slots),
                         cache_slot_update_plain(cv, uv_, slots))})
    t["bound"] = bound_ms(2 * 2 * 2 * VB * 2 * 128, 0)
    rows["cache_slot_update"] = {"at_qwen2vl_cache": t}
    log(f"[timing] torch.bfloat16 cache_kv_update (K and V) at qwen2-vl-2b's "
        f"({VB}, {VMAX}, 2, 128): {t['ms']:.5f} ms, plain "
        f"{t['plain_ms']:.5f} ms, library (indexed writes, twice) "
        f"{t['library_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
        f"({t['bound'][1]})")
    return err, rows



def vlm_generate(torch, model, params, batch, head, new, max_len,
                 dtype=None, feed=None):
    """Greedy decode of a vlm batch {tokens (B, T), patches (B, P, d)} on
    the model API (the engine refuses the family): a prefill into a cache
    of ``max_len`` slots in ``dtype`` (the model's default, bfloat16,
    when None) and ``new`` - 1 decode steps, token j at pos P + T + j (the
    reference's convention), each next token from ``head.next``; ``feed``
    (B, new) decodes those tokens instead (teacher forcing). → (tokens
    (B, new) numpy, the hidden state before each step (B, new, d))."""
    P, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    kw = {} if dtype is None else {"dtype": dtype}
    dev = batch["tokens"].device
    with torch.inference_mode():
        cache = model.init_cache(len(batch["tokens"]), max_len,
                                 device=dev, **kw)
        h, cache = model.prefill(params, batch, cache)
        h1 = h[:, -1]
        hs, toks = [h1], [head.next(h1)]
        for j in range(new - 1):
            tok = toks[-1] if feed is None else torch.as_tensor(
                feed[:, j], device=dev)
            h1, cache = model.decode_step(params, tok, cache, P + T + j)
            hs.append(h1)
            toks.append(head.next(h1))
    return torch.stack(toks, 1).cpu().numpy(), torch.stack(hs, 1)


def vlm_gap_rule(torch, np, tag, model, params, batch, got, want, max_len,
                 hx, W, b):
    """Each row of ``got`` equals ``want``'s, or first differs after a step
    whose exact top-2 gap (bf16 logits, on ``want``'s path, teacher-forced
    through the exact head ``hx``) is below GAP_BF16. → [(row, step, gap)]
    of the rows that differ."""
    rows = [i for i in range(len(want))
            if not np.array_equal(got[i], want[i])]
    if not rows:
        return []
    _, H = vlm_generate(torch, model, params, batch, hx, want.shape[1],
                        max_len, feed=want)
    out = []
    for i in rows:
        t = int(np.nonzero(got[i] != want[i])[0][0])
        top = (H[i, t][None] @ W.T + b).float().topk(2, dim=-1).values
        gap = float(top[0, 0] - top[0, 1])
        check(gap < GAP_BF16, f"{tag}: row {i} differs at step {t} with a "
              f"top-2 gap {gap:.4g} >= {GAP_BF16}")
        out.append((i, t, round(gap, 5)))
    return out


def phase_vlm(torch, np):
    """[vlm] qwen2-vl-2b at full width in its config's bfloat16 (drawn on
    the card, vision_proj included) through the model API: prefill 4 x
    (256 patches + 256 tokens) into a bf16 cache of 544 slots, then 32
    greedy tokens through exact, screened-cuda fused and unfused (random
    screen, r = 100, K = 16 over 1,187 tiles) and a full cover: fused ==
    unfused tokens bit for bit, the full cover == exact under the bf16 gap
    rule; launches from zero (the cache pair 28 a decode step, the route a
    token on each screened run, the fused kernel a token on the fused
    runs, the gather kernel a token on the unfused run, only the bf16
    bodies); profiles of an unfused and a fused run of 4 tokens (device
    calls == counted launches, idle share); prefill positions/s, the
    decode step on the host clock and its device time (a profile of 4
    steps), one step's exact head against screened-cuda's (clean L2) with
    their bounds, and the step's weight-read bound. → launches of the
    path."""
    from repro_torch import heads
    from repro_torch.kernels import ops

    g = dense_model(torch, np, "qwen2-vl-2b", "[vlm]", full=True)
    model, params = g["model"], g["params"]
    cfg = model.cfg
    check((cfg.d_model, cfg.vocab_size, cfg.num_kv_heads, cfg.head_dim,
           cfg.num_layers, cfg.num_patch_tokens, cfg.positional) ==
          (VD, VV, 2, 128, 28, VP, "mrope"),
          "qwen2-vl-2b: config drifted from the smoke's shapes")
    n_formula = cfg.param_count() + VD * VD
    side = int(VP ** 0.5)                    # the patch grid's side, 16
    rng = g["rng"]
    gcu = torch.Generator(device="cuda").manual_seed(105)
    batch = {"tokens": torch.as_tensor(rng.integers(0, VV, (VB, VT)),
                                       device="cuda"),
             "patches": torch.randn((VB, VP, VD), generator=gcu,
                                    device="cuda")}
    W, b = model.softmax_weights(params)
    screen = g["screen"].to("cuda")
    kw = dict(W=W, b=b, device="cuda")
    hx = heads.get("exact", **kw)
    hf = heads.get("screened-cuda", screen=screen, **kw)
    hu = heads.get("screened-cuda", screen=screen, fused=False, **kw)
    hc = heads.get("screened-cuda", screen=g["full"], **kw)
    check(hf.prepare()._Wb.dtype == torch.bfloat16 and
          hf.packed_shape == (VV // V_BLK, V_BLK, VD),
          f"qwen2-vl-2b: packed head {hf.packed_shape}")

    def run(head, **k):
        return vlm_generate(torch, model, params, batch, head, VNEW, VMAX,
                            **k)
    small = {"tokens": batch["tokens"][:, :16],
             "patches": batch["patches"][:, :16]}
    for hd in (hx, hf, hu, hc):                        # warm-up
        vlm_generate(torch, model, params, small, hd, 2, 40)
    with torch.inference_mode():
        cache = model.init_cache(VB, VMAX, device="cuda")
        _, t_prefill = host_timed(torch, lambda: model.prefill(
            params, batch, cache))
        del cache

    ops.reset_launches()
    (exact, hs_x), t_exact = host_timed(torch, lambda: run(hx))
    (scr, _), t_scr = host_timed(torch, lambda: run(hf))
    scr_u, _ = run(hu)
    f_scr, _ = run(hc)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_runs, steps = 4, VNEW - 1
    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u), ("full cover", f_scr)):
        check(r.shape == (VB, VNEW) and r.min() >= 0 and r.max() < VV,
              f"[vlm] qwen2-vl-2b {name}: tokens out of range")
    check(bool(torch.isfinite(hs_x.float()).all()),
          "[vlm] qwen2-vl-2b: non-finite hidden states")
    check(np.array_equal(scr, scr_u),
          "[vlm] qwen2-vl-2b: screened-cuda fused and unfused tokens differ")
    want = {"cache_slot_update": cfg.num_layers * steps * n_runs,
            "cluster_route_bf16": 3 * VNEW, "fused_screened_topk_bf16":
            2 * VNEW, "screened_logits_bf16": VNEW}
    check(all(launches[k] == n for k, n in want.items()) and
          not any(launches[k] for k in L2S_KERNELS + ("ssd_intra",
                                                      "ssd_intra_bwd")),
          f"[vlm] qwen2-vl-2b: launches {launches}, expected {want} (the "
          f"bf16 L2S bodies only)")
    near_full = vlm_gap_rule(torch, np, "[vlm] qwen2-vl-2b full cover",
                             model, params, batch, f_scr, exact, VMAX, hx, W,
                             b)

    def short(head):
        return vlm_generate(torch, model, params, batch, head, VPROF, VMAX)
    profile_counted(torch, f"[vlm] qwen2-vl-2b greedy {VPROF} tokens "
                    f"screened-cuda unfused", lambda: short(hu))
    _, t_short = host_timed(torch, lambda: short(hf))
    kern = profile_counted(torch, f"[vlm] qwen2-vl-2b greedy {VPROF} tokens "
                           f"screened-cuda", lambda: short(hf))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    # decode steps alone, from a primed cache (each run writes the same
    # slots)
    P_T = VP + VT
    with torch.inference_mode():
        cache = model.init_cache(VB, VMAX, device="cuda")
        h, cache = model.prefill(params, batch, cache)
        tok0 = hf.next(h[:, -1])

        def steps(times=None):
            tok = tok0
            for j in range(VPROF):
                t0 = time.perf_counter()
                h1, _ = model.decode_step(params, tok, cache, P_T + j)
                tok = hf.next(h1)
                if times is not None:
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
        steps()
        times = []
        for _ in range(2):
            steps(times)
        _, t_steps = host_timed(torch, steps)
        s_busy, s_idle, s_ours, _ = device_profile(
            torch, f"[vlm] qwen2-vl-2b {VPROF} decode steps", steps, t_steps)
    step_ms = statistics.median(times)
    timer = Timer(torch)
    hq = torch.randn((VB, VD), generator=torch.Generator().manual_seed(106))
    heads_t, tiles = head_rows(torch, timer, hx, hf, W, screen,
                               hq.cuda().to(torch.bfloat16))
    stack_b, head_b = step_weight_bytes(params)
    scr_b = 4 * g["screen"].v.numel() + tiles * V_BLK * (VD + 1) * 2
    tok = VB * VNEW
    log(f"[vlm] qwen2-vl-2b: {g['n_params']} parameters in its tensors "
        f"(param_count {cfg.param_count()} + vision_proj {VD * VD} = "
        f"{n_formula}, + qkv biases, final norm and lm_bias), "
        f"{g['nbytes'] / 1e9:.3f} GB bf16; packed head {hf.packed_shape} bf16 "
        f"{hf.packed_nbytes / 1e6:.1f} MB")
    log(f"[vlm] qwen2-vl-2b through Model.prefill / decode_step (bf16 cache "
        f"of {VMAX} slots): greedy {VB}x({VP} patches + {VT} tokens)+{VNEW}, "
        f"decode at pos {P_T} + j (the prompt's M-RoPE text positions "
        f"{side}..{side + VT - 1} on its {side} x {side} patch grid): exact "
        f"{t_exact:.3f} s "
        f"({tok / t_exact:.1f} tok/s), screened-cuda {t_scr:.3f} s "
        f"({tok / t_scr:.1f} tok/s), eager steps; fused == unfused tokens; "
        f"full cover (K={g['full'].c_max}) screened-cuda == exact except rows "
        f"first differing after a step with a gap < {GAP_BF16}: {near_full}")
    log(f"[vlm] qwen2-vl-2b profile, greedy {VB}x({VP}+{VT})+{VPROF} "
        f"screened-cuda: device busy {busy_ms:.3f} ms of {t_short * 1e3:.3f} "
        f"ms unprofiled wall (idle share {1 - busy_ms / (t_short * 1e3):.3f}); "
        f"{fused_share(kern, busy_ms, 'fused_screened_topk_bf16')}")
    log(f"[vlm] qwen2-vl-2b decode step (B={VB}, screened-cuda, eager): host "
        f"clock median {step_ms:.3f} ms of {len(times)}; {VPROF} steps "
        f"profiled: device busy {s_busy / VPROF:.4f} ms a step, idle share "
        f"{s_idle:.3f} against their {t_steps * 1e3 / VPROF:.3f} ms wall a "
        f"step; the port's kernels "
        + json.dumps({k: [round(ms / VPROF, 5), n // VPROF]
                      for k, (ms, n) in s_ours.items()})
        + f" (ms and calls a step); prefill {VB}x{P_T} {t_prefill:.3f} s "
        f"({VB * P_T / t_prefill:.0f} positions/s, host clock)")
    log(f"[vlm] qwen2-vl-2b one step's head, device time (clean L2, CUDA "
        f"events, B={VB}): exact {heads_t['exact'][0]:.5f} ms (bound "
        f"{heads_t['exact'][1][0]:.5f} ms, {heads_t['exact'][1][1]}), "
        f"screened-cuda {heads_t['screened-cuda'][0]:.5f} ms (bound "
        f"{heads_t['screened-cuda'][1][0]:.5f} ms, "
        f"{heads_t['screened-cuda'][1][1]}; {tiles} distinct tiles), ratio "
        f"{heads_t['exact'][0] / heads_t['screened-cuda'][0]:.1f}")
    log(f"[vlm] qwen2-vl-2b weight-read bound of a decode step at 3.35 TB/s: "
        f"layers {stack_b / 1e9:.4f} GB + exact head {head_b / 1e9:.4f} GB = "
        f"{(stack_b + head_b) / HBM_BYTES_PER_S * 1e3:.4f} ms; with "
        f"screened-cuda's {scr_b / 1e6:.2f} MB of head instead "
        f"{(stack_b + scr_b) / HBM_BYTES_PER_S * 1e3:.4f} ms; the exact head "
        f"is {head_b / (stack_b + head_b):.1%} of the exact step's bytes")
    log(f"[vlm] qwen2-vl-2b launches on the path ({n_runs} greedy runs, "
        f"counted from zero): {json.dumps(launches)}")
    return launches


def phase_vlm_cpu(torch, np):
    """[vlm] card vs CPU: qwen2-vl-2b at full widths cut to 2 layers, in
    float32 (weights from a CPU generator, the same on both sides): a
    prefill of 2 x (256 patches + 64 tokens) and 8 decode steps through the
    exact head, the card fed the CPU's tokens: every hidden state within
    1e-4 of max |h|, and the card's greedy token at each step equal to the
    CPU's unless the CPU's top-2 gap there is below 1e-4."""
    from dataclasses import replace

    from repro_torch import heads
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    cfg = replace(get_config("qwen2-vl-2b"), num_layers=2, dtype="float32")
    model = Model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(107), device="cpu")
    p_gpu = to_device(p_cpu, "cuda")
    rng = np.random.default_rng(107)
    b_cpu = {"tokens": torch.as_tensor(rng.integers(0, VV, (VCPU_B, VCPU_T))),
             "patches": torch.as_tensor(rng.standard_normal(
                 (VCPU_B, VP, VD)).astype(np.float32))}
    b_gpu = {k: x.cuda() for k, x in b_cpu.items()}
    max_len = VP + VCPU_T + VCPU_NEW
    side = {}
    for where, p, bt in (("cpu", p_cpu, b_cpu), ("cuda", p_gpu, b_gpu)):
        W, b = model.softmax_weights(p)
        hd = heads.get("exact", W=W, b=b, device=where)
        feed = None if where == "cpu" else side["cpu"][0]
        side[where] = vlm_generate(torch, model, p, bt, hd, VCPU_NEW,
                                   max_len, dtype=torch.float32, feed=feed)
    toks, h_cpu = side["cpu"]
    got, h_gpu = side["cuda"]
    rel = float((h_gpu.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
    check(rel <= 1e-4, f"[vlm] card vs CPU: hidden states rel {rel:.3g} > "
          f"1e-4")
    W, b = model.softmax_weights(p_cpu)
    top = (h_cpu @ W.T + b).topk(2, dim=-1).values
    gaps = (top[..., 0] - top[..., 1]).numpy()
    diff = got != toks
    check(bool((gaps[diff] < GAP).all()), f"[vlm] card vs CPU: greedy "
          f"tokens differ at steps whose gap is >= {GAP}: {gaps[diff]}")
    log(f"[vlm] card vs CPU, qwen2-vl-2b full widths cut to 2 layers, "
        f"float32: prefill {VCPU_B}x({VP} patches + {VCPU_T} tokens) + "
        f"{VCPU_NEW - 1} decode steps at pos {VP + VCPU_T} + j, the card fed "
        f"the CPU's tokens: max |h_card - h_cpu| / max |h_cpu| {rel:.3g} "
        f"(<= 1e-4); greedy tokens equal at {int((~diff).sum())} of "
        f"{diff.size} steps, the rest near ties (gap < {GAP}): "
        f"{int(diff.sum())}")
    del p_gpu
    gc.collect()
    torch.cuda.empty_cache()


def phase_audio(torch, np):
    """[audio] hubert-xlarge at full width, bf16 weights drawn on the card
    with float32 frames (the reference's promotion: float32 activations):
    the forward over 4 x 1,024 frames (float32 h, finite; frames/s on the
    host clock and peak device memory, no port kernel launched); 2 layers,
    card against CPU within 1e-4 of max |h|; one input of 2,048 frames
    (the non-causal chunked attention path) against the unchunked path on
    the card within 1e-5 relative. → launches of the path."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.layers import attention
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("hubert-xlarge")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(108),
                        device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.dtype == torch.bfloat16 for t in leaves),
          "hubert-xlarge: weights not in its config's bfloat16")
    gcu = torch.Generator(device="cuda").manual_seed(109)
    frames = torch.randn((HB, HT, HD), generator=gcu, device="cuda")
    with torch.inference_mode():
        model.forward(params, {"frames": frames[:, :64]})      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        (h, _), t_fwd = host_timed(torch, lambda: model.forward(
            params, {"frames": frames}))
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(h.dtype == torch.float32 and h.shape == (HB, HT, HD) and
              bool(torch.isfinite(h).all()),
              f"[audio] hubert-xlarge: h {h.dtype} {tuple(h.shape)}")
        check(not any(launches.values()),
              f"[audio] hubert-xlarge launched port kernels {launches}")
        del h
        long = torch.randn((1, HLONG, HD), generator=gcu, device="cuda")
        h_chunked, _ = model.forward(params, {"frames": long})
        thr = attention.CHUNKED_ATTN_THRESHOLD
        attention.CHUNKED_ATTN_THRESHOLD = 1 << 30
        try:
            h_full, _ = model.forward(params, {"frames": long})
        finally:
            attention.CHUNKED_ATTN_THRESHOLD = thr
        rel_long = float((h_chunked - h_full).abs().max() /
                         h_full.abs().max())
        del h_chunked, h_full
    check(rel_long <= 1e-5, f"[audio] 2,048 frames: chunked vs unchunked "
          f"rel {rel_long:.3g} > 1e-5")
    log(f"[audio] hubert-xlarge: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads (MHA, hd {cfg.head_dim}), gelu d_ff="
        f"{cfg.d_ff}, layernorm, {cfg.vocab_size} units, untied, sinusoidal "
        f"positions, bidirectional: {n_params} parameters drawn on the card "
        f"in {t_init:.1f} s, bfloat16, {nbytes / 1e9:.3f} GB (param_count "
        f"{cfg.param_count()} + frame_proj {HD * HD} + biases)")
    log(f"[audio] hubert-xlarge forward {HB}x{HT} float32 frames against bf16 "
        f"weights: h float32, {t_fwd:.3f} s ({HB * HT / t_fwd:.0f} frames/s, "
        f"host clock, one call ending in a sync); peak device memory "
        f"{peak:.2f} GiB; no port kernel launched; one input of {HLONG} "
        f"frames (chunked, non-causal) vs the unchunked path: max rel "
        f"{rel_long:.3g} (<= 1e-5)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = replace(cfg, num_layers=2)
    m2 = Model(cfg2)
    p_cpu = m2.init(torch.Generator().manual_seed(110), device="cpu")
    fr = torch.as_tensor(np.random.default_rng(110).standard_normal(
        (2, 256, HD)).astype(np.float32))
    with torch.inference_mode():
        h_cpu, _ = m2.forward(p_cpu, {"frames": fr})
        h_gpu, _ = m2.forward(to_device(p_cpu, "cuda"),
                              {"frames": fr.cuda()})
    rel = float((h_gpu.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
    check(h_gpu.dtype == torch.float32 and rel <= 1e-4,
          f"[audio] card vs CPU: rel {rel:.3g} > 1e-4 ({h_gpu.dtype})")
    log(f"[audio] card vs CPU, hubert-xlarge full width cut to 2 layers, "
        f"bf16 weights, 2 x 256 float32 frames: max |h_card - h_cpu| / max "
        f"|h_cpu| {rel:.3g} (<= 1e-4)")
    return {"hubert-xlarge": launches}


def train_launcher(torch, tag, arch, corpus_s):
    """``python -m repro_torch.launch.train --arch ARCH --steps 2 --batch 4
    --seq 512`` at full width in float32 on the card: exit 0, two steps,
    the corpus built in <= ``corpus_s`` s, peak device memory under 80 GiB.
    → (launches, seconds, corpus build seconds, peak GiB)."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", arch, "--device", "cuda", "--steps", "2", "--batch",
            "4", "--seq", "512", "--log-every", "1"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(ops.LAUNCHES)
    text = out.getvalue()
    corpus = [ln for ln in text.splitlines() if "[train] corpus" in ln]
    check(rc == 0 and text.count("[train] step") == 2 and corpus and
          peak < 80.0, f"{tag} launch.train {arch}: exit {rc}, peak "
          f"{peak:.2f} GiB:\n{text}")
    build_s = float(corpus[0].split(" built in ")[1].split(" s")[0])
    check(build_s <= corpus_s, f"{tag} the corpus took {build_s:.1f} s")
    for ln in text.splitlines():
        log(ln)
    log(f"{tag} python -m repro_torch.launch.train {' '.join(argv)}: exit 0 "
        f"in {secs:.1f} s (full width, float32, remat none); corpus build "
        f"{build_s:.1f} s on the host; peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_vlm(torch, np):
    """[train-vlm] the launcher on full-width qwen2-vl-2b in float32 (4 x
    (256 patches + 512 tokens), the loss over the 512 text positions; the
    151,936-word corpus built on the host), then 2 layers, card against
    CPU gradients at 1 x (256 patches + 128 tokens). → {path: launches}."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    launches = train_launcher(torch, "[train-vlm]", "qwen2-vl-2b", 60.0)
    text = card_vs_cpu_grads(torch, np, "[train-vlm] qwen2-vl-2b 2 layers",
                             replace(get_config("qwen2-vl-2b"), num_layers=2),
                             128, 111)
    log(f"[train-vlm] qwen2-vl-2b full widths, 2 layers, 1 x (256 patches + "
        f"128 tokens): {text}; phase wall {time.perf_counter() - t_phase:.1f} "
        f"s")
    return {"qwen2-vl-2b train": launches}


def phase_train_audio(torch, np):
    """[train-audio] the launcher on full-width hubert-xlarge in float32 (4
    x 512 float32 frames, masked-prediction labels over 504 units), then 2
    layers, card against CPU gradients at 1 x 256 frames.
    → {path: launches}."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    launches = train_launcher(torch, "[train-audio]", "hubert-xlarge", 60.0)
    text = card_vs_cpu_grads(torch, np,
                             "[train-audio] hubert-xlarge 2 layers",
                             replace(get_config("hubert-xlarge"),
                                     num_layers=2), 256, 112)
    log(f"[train-audio] hubert-xlarge full width, 2 layers, 1 x 256 frames: "
        f"{text}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"hubert-xlarge train": launches}


# -- the sharded dry run, and the kernels on DTensors ---------------------------
MESH_B = 4                       # rows of the (1, 1)-mesh decode steps
MESH_S = 64                      # their K/V cache slots


def mesh_count(torch, name, shape_name, head):
    """One combination counted on the 16x16 counting mesh on meta (the
    dry run's ``lower_combo``); its argument bytes held to the sum of each
    argument's shard bytes, as the shardings' specs give them. → the
    record."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import local_shape
    from repro_torch.tree import tree_flatten

    cfg = get_config(name)
    shape = INPUT_SHAPES[shape_name]
    with make_production_mesh() as mesh:
        t0 = time.perf_counter()
        rec = dryrun.lower_combo(cfg, shape, mesh, head=head)
        secs = time.perf_counter() - t0
        _, args, in_sh, _, _ = dryrun.mesh_step(cfg, shape, mesh, head)
        pairs = [(t, sh) for a, s in zip(args, in_sh)
                 for t, sh in zip(tree_flatten(a), tree_flatten(s))]
        unread = {id(t) for t in tree_flatten(dryrun._unread(cfg, shape,
                                                             args))}
        want = sum(math.prod(local_shape(t.shape, sh.spec, mesh)) *
                   t.element_size() for t, sh in pairs if id(t) not in unread)
    check("error" not in rec, f"[mesh] {name} {shape_name}: {rec}")
    mem, rl = rec["memory"], rec["roofline"]
    check(mem["argument_bytes"] == want,
          f"[mesh] {name} {shape_name}: argument bytes "
          f"{mem['argument_bytes']} != the shards' {want}")
    kinds = {k: int(v["bytes"]) for k, v in rl["collectives"].items()
             if v["count"]}
    log(f"[mesh] {name} {shape_name} head={head} on the {rec['mesh']} "
        f"counting mesh (meta, this machine's torch {torch.__version__}), "
        f"one device: argument {mem['argument_bytes']} B (== its shards' "
        f"bytes), temp {mem['temp_bytes']} B, {rl['flops_per_dev']:.6e} "
        f"FLOPs, {rl['bytes_per_dev']:.6e} bytes, collective bytes "
        f"{rl['collective_bytes_per_dev']:.6e} by kind {json.dumps(kinds)}, "
        f"bound {rl['bound_s'] * 1e3:.4f} ms ({rl['dominant']}), counted in "
        f"{secs:.1f} s")
    return rec


def mesh_decode(torch, np, name, seed):
    """The l2s decode step of ``name`` at full width (and depth) in its
    config's dtype on the card, once as it is and once with its params,
    screen, cache and inputs DTensors on a (1, 1) mesh over the card: the
    route and fused kernels then launch through ``local_map``. Ids equal
    bit for bit; launches from zero. → the mesh run's launches."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.launch.sharding import (NamedSharding, cache_shardings,
                                             distribute, params_shardings)
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    from repro_torch.tree import tree_map
    from repro_torch.utils import shard

    cfg = get_config(name)
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, device="cuda")
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    n_blk = -(-cfg.vocab_size // V_BLK)
    v = torch.from_numpy(rng.standard_normal((R, cfg.d_model)).astype(
        np.float32)).cuda()
    cand = torch.from_numpy(rng.integers(0, n_blk + 1, (R, K)).astype(
        np.int32)).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, MESH_B).astype(
        np.int32)).cuda()
    pos = torch.tensor(MESH_S // 2, dtype=torch.int32, device="cuda")
    cache = model.init_cache(MESH_B, MESH_S, dtype=dt, device="cuda")
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device="cuda").to(t.dtype), cache)
    step = make_serve_step(model, head="l2s")
    clone = lambda c: tree_map(lambda t: t.clone(), c)      # noqa: E731
    with torch.no_grad():
        ops.reset_launches()
        ids0, vals0, _ = step(params, v, cand, clone(cache), tok, pos)
        torch.cuda.synchronize()
        plain = {k: n for k, n in ops.LAUNCHES.items() if n}
        with CountingMesh((1, 1), ("data", "model"),
                          device_type="cuda") as mesh:
            rep = NamedSharding(mesh, ())
            args = (distribute(params, params_shardings(mesh, cfg, params)),
                    *distribute([v, cand], [rep, rep]),
                    distribute(clone(cache), cache_shardings(mesh, cfg,
                                                             cache)),
                    *distribute([tok, pos], [rep, rep]))
            ops.reset_launches()
            with shard.use_mesh(mesh), implicit_replication():
                ids1, vals1, _ = step(*args)
            torch.cuda.synchronize()
            launches = {k: n for k, n in ops.LAUNCHES.items() if n}
            ids1, vals1 = ids1.to_local(), vals1.to_local()
            backend = torch.distributed.get_backend()
    sfx = ops.BF16 if dt == torch.bfloat16 else ""
    check(launches.get("cluster_route" + sfx, 0) >= 1 and
          launches.get("fused_screened_topk" + sfx, 0) >= 1 and
          launches == plain,
          f"[mesh] {name}: launches on the mesh {launches}, without {plain}")
    check(torch.equal(ids0, ids1),
          f"[mesh] {name}: ids on the (1, 1) mesh differ from the step's")
    log(f"[mesh] {name} l2s decode step, {cfg.num_layers} layers, d = "
        f"{cfg.d_model}, V = {cfg.vocab_size}, {cfg.dtype}, B = {MESH_B}, "
        f"a {MESH_S}-slot cache at pos {MESH_S // 2}: on a (1, 1) mesh over "
        f"the card ({backend} group) the ids equal the step's without one "
        f"bit for bit; vals max |diff| "
        f"{(vals0 - vals1).abs().max().item():.3e}; launches "
        f"{json.dumps(launches)}, the same as without a mesh")
    return launches


def phase_mesh(torch, np):
    """[mesh] (a) the sharded dry run on this machine's torch: gemma-2b
    decode_32k through the l2s head and mamba2-1.3b prefill_32k (through
    ``ssd_intra``) at full width and depth counted on the 16x16 counting
    mesh, one device's numbers printed, each record's
    argument bytes held to its shards' bytes; (b) the kernels on DTensors:
    nmt-deen-lstm's and gemma-2b's l2s decode steps at full width and
    depth on a (1, 1) mesh over the card, ids bit-identical to the steps
    without one. → launches of (b)'s paths."""
    t0 = time.perf_counter()
    mesh_count(torch, "gemma-2b", "decode_32k", "l2s")
    mesh_count(torch, "mamba2-1.3b", "prefill_32k", "full")
    paths = {"nmt-deen-lstm mesh (1, 1)": mesh_decode(torch, np,
                                                      "nmt-deen-lstm", 5)}
    gc.collect()
    torch.cuda.empty_cache()
    paths["gemma-2b mesh (1, 1)"] = mesh_decode(torch, np, "gemma-2b", 6)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh] took {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible; nothing to run",
              file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.model import to_device
    from repro_torch.serving import DecodeEngine

    resolve_device("cuda")                     # TF32 off for float32 matmuls
    if sys.argv[1:] == ["--only", "train-ssm"]:
        # phase_train_ssm_fresh's process: its result as the last line
        print(json.dumps(phase_train_ssm(torch, np)), flush=True)
        return 0
    kind, _ = phase_device(torch)
    walled("build", phase_build, ops)
    if sys.argv[1:] == ["--only", "cost"]:
        # the [cost] phase alone, after the training it audits; no result
        # lines
        _, ctx = walled("train and l2s", phase_train_l2s, torch, np)
        walled("cost", phase_cost, torch, np, ctx)
        log(f"[done] --only cost took {time.perf_counter() - T_START:.1f} s;"
            f" phase walls (s): {json.dumps(WALLS)}")
        return 0
    if sys.argv[1:] == ["--only", "mesh"]:
        # the [mesh] phase alone; no result lines
        walled("mesh", phase_mesh, torch, np)
        log(f"[done] --only mesh took {time.perf_counter() - T_START:.1f} s;"
            f" phase walls (s): {json.dumps(WALLS)}")
        return 0
    if sys.argv[1:] == ["--only", "fused-batch"]:
        # [fused-batch] alone; its rows as the last line
        rows = walled("fused batch", phase_fused_batch, torch, np)
        log(f"[done] --only fused-batch took "
            f"{time.perf_counter() - T_START:.1f} s; phase walls (s): "
            f"{json.dumps(WALLS)}")
        print(json.dumps({"fused_screened_topk_at_translation_batch": rows}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--only", "sharded"]:
        # the [sharded] phases alone, after the training that (a) decodes
        # with; no result lines
        _, ctx = walled("train and l2s", phase_train_l2s, torch, np)
        walled("sharded lstm", phase_sharded_lstm, torch, np, ctx)
        walled("sharded gemma-vocab", phase_sharded_gemma, torch, np)
        log(f"[done] --only sharded took {time.perf_counter() - T_START:.1f}"
            f" s; phase walls (s): {json.dumps(WALLS)}")
        return 0
    err = walled("parity", phase_parity, torch, np, K)
    err["fused_screened_topk"] = max(err["fused_screened_topk"], walled(
        "fused split", phase_fused_split, torch, np))
    err["screened_logits"] = max(err["screened_logits"], walled(
        "screen grid", phase_screen_grid, torch, np))
    err.update(walled("parity bf16", phase_parity_bf16, torch, np))
    times, wide, beam = walled("timing", phase_timing, torch, np)
    batch_rows = walled("fused batch", phase_fused_batch, torch, np)
    times.update({name: wide[name] for name in BF16_KERNELS})
    register_unfused()
    lstm, ctx = walled("e2e", phase_e2e, torch, np)
    graph_lstm = walled(
        "graph lstm", phase_graph, torch, np, "nmt-deen-lstm",
        DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                     device="cuda"), ctx["prompts"], 16, 5, True)
    serve = walled("serve", phase_serve, torch, np, ctx)
    del ctx
    l2s_fit, ctx = walled("train and l2s", phase_train_l2s, torch, np)
    heads_lstm, steps_lstm = walled("heads", phase_heads, torch, np, ctx)
    eng, stream_lstm = walled("stream lstm", phase_stream_lstm, torch, np,
                              ctx)
    sched = walled("sched", phase_sched, torch, np, eng, ctx)
    del eng
    spec_lstm, dist_err = walled("spec lstm", phase_spec_lstm, torch, np,
                                 ctx)
    err["screened_logits"] = max(err["screened_logits"], dist_err)
    pool_lstm = walled("pool", phase_pool_lstm, torch, np, ctx)
    # kept on the host for [sharded] and [cost], run last: the card's
    # memory stays as the phases between were written for
    l2s_ctx = dict(ctx, params=to_device(ctx["params"], "cpu"),
                   screen=ctx["screen"].to("cpu"))
    del ctx
    walled("serve-cli", phase_serve_cli, torch)
    ssm_err, ssm_times = walled("ssm kernels", phase_ssm_kernels, torch)
    err.update(ssm_err)
    times.update(ssm_times)
    ctx = walled("hybrid f32", phase_hybrid_f32, torch, np)
    graph_hybrid = walled(
        "graph zamba2", phase_graph, torch, np, "zamba2-2.7b",
        DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                     max_len=ZMAX, device="cuda"), ctx["prompts"],
        ZGRAPH_NEW, 4, False)
    zcfg = ctx["model"].cfg
    n_attn = zcfg.num_layers // zcfg.hybrid_shared_period
    check(graph_hybrid["cache_slot_update"] ==
          n_attn * 6 * (ZGRAPH_NEW - 1) and
          graph_hybrid["ssd_intra"] == zcfg.num_layers * 6,
          f"[graph] zamba2-2.7b: launches {graph_hybrid}, expected "
          f"{n_attn} cache and {zcfg.num_layers} SSD launches per decode "
          f"step and per prefill")
    hybrid = walled("hybrid", phase_e2e_hybrid, torch, np, ctx["f32"])
    ssm_bf16 = walled("ssm bf16", phase_ssm_bf16, torch, np)
    stream_hybrid = walled("stream zamba2", phase_stream_hybrid, torch, np,
                           ctx)
    spec_hybrid = walled("spec zamba2", phase_spec_hybrid, torch, np, ctx)
    adaptive_z, steps_z = walled("adaptive zamba2", phase_adaptive_hybrid,
                                 torch, np, ctx)
    del ctx
    costs = walled("launch costs", launch_costs, torch, np)
    dense_err, dense_rows = walled("dense kernels", phase_dense_kernels,
                                   torch, np)
    for name, e in dense_err.items():
        err[name] = max(err[name], e)
    gemma, g = walled("dense gemma", phase_dense_gemma, torch, np)
    gemma_paged = walled("dense paged", phase_dense_paged, torch, np, g)
    gemma_spec = walled("dense spec", phase_dense_spec, torch, np, g)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    starcoder = walled("dense starcoder2", phase_dense_starcoder2, torch, np)
    qwen = walled("dense qwen", phase_dense_qwen, torch, np)
    walled("dense serve-cli", cli_dense, torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_err, moe_rows = walled("moe kernels", phase_moe_kernels, torch, np)
    for name, e in moe_err.items():
        err[name] = max(err[name], e)
    for name, shapes in moe_rows.items():
        dense_rows.setdefault(name, {}).update(shapes)
    moe, g = walled("moe mixtral", phase_moe_mixtral, torch, np)
    moe["mixtral-8x7b spec"] = walled("moe spec", phase_moe_spec, torch, np,
                                      g)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    walled("moe ring f32", phase_moe_ring_f32, torch, np)
    moe.update(walled("moe phi", phase_moe_phi, torch, np))
    gc.collect()
    torch.cuda.empty_cache()
    vlm_err, vlm_rows = walled("vlm kernels", phase_vlm_kernels, torch, np)
    for name, e in vlm_err.items():
        err[name] = max(err[name], e)
    for name, shapes in vlm_rows.items():
        dense_rows.setdefault(name, {}).update(shapes)
    vlm = walled("vlm", phase_vlm, torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    walled("vlm cpu", phase_vlm_cpu, torch, np)
    audio = walled("audio", phase_audio, torch, np)
    # training last, so the serving phases' profiles, held to the wrappers'
    # counts, run in the process state they were written for: with these
    # two phases ahead of them, the profiler left the zamba2 adaptive
    # profile one ssd_intra record short of ~105,600, in both attempts
    bwd_err, bwd_times, train_ssm = walled("train-ssm", phase_train_ssm_fresh,
                                           torch)
    err.update(bwd_err)
    times.update(bwd_times)
    walled("serve-cli zamba2", cli_zamba2, torch)
    train_attn = walled("train-dense", phase_train_dense, torch, np)
    train_attn.update(walled("train-moe", phase_train_moe, torch, np))
    train_attn.update(walled("train-vlm", phase_train_vlm, torch, np))
    train_attn.update(walled("train-audio", phase_train_audio, torch, np))
    # the sharded heads after every other phase, so that no phase before
    # runs in another process state than it was written for
    gc.collect()
    torch.cuda.empty_cache()
    l2s_ctx.update(params=to_device(l2s_ctx["params"], "cuda"),
                   screen=l2s_ctx["screen"].to("cuda"))
    sharded_lstm = walled("sharded lstm", phase_sharded_lstm, torch, np,
                          l2s_ctx)
    cost_err, cost_paths = walled("cost", phase_cost, torch, np, l2s_ctx)
    for name, e in cost_err.items():
        err[name] = max(err[name], e)
    del l2s_ctx
    sharded_gemma, shard_rows = walled("sharded gemma-vocab",
                                       phase_sharded_gemma, torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_paths = walled("mesh", phase_mesh, torch, np)
    # each kernel's launches on the path it was ported for, and on each path
    launches = {k: (hybrid if k in BF16_KERNELS or k in ssm_err else
                    lstm)[k] for k in lstm}
    launches["ssd_intra_bwd"] = train_ssm["zamba2-2.7b train"]["ssd_intra_bwd"]
    paths = {"nmt-deen-lstm": lstm, "nmt-deen-lstm graph": graph_lstm,
             "serve": serve, "nmt-deen-lstm l2s-fit": l2s_fit,
             "zamba2-2.7b": hybrid,
             "mamba2-1.3b bf16": ssm_bf16,
             "zamba2-2.7b graph": graph_hybrid,
             "nmt-deen-lstm stream": stream_lstm,
             "nmt-deen-lstm scheduler": sched,
             "zamba2-2.7b stream": stream_hybrid,
             "nmt-deen-lstm heads": heads_lstm,
             "nmt-deen-lstm sharded": sharded_lstm,
             "gemma-2b-vocab sharded": sharded_gemma,
             "zamba2-2.7b adaptive": adaptive_z,
             "nmt-deen-lstm spec": spec_lstm,
             "nmt-deen-lstm paged": pool_lstm,
             "zamba2-2.7b spec": spec_hybrid,
             "gemma-2b bf16": gemma, "gemma-2b paged": gemma_paged,
             "gemma-2b spec": gemma_spec, "starcoder2-3b bf16": starcoder,
             "qwen1.5-110b bf16": qwen, **moe, "qwen2-vl-2b bf16": vlm,
             **audio, **train_ssm, **train_attn, **cost_paths,
             **mesh_paths}

    replaces = {"cluster_route": ("src/repro_torch/csrc/route.cu",
                                  "src/repro/kernels/route.py:49"),
                "screened_logits": ("src/repro_torch/csrc/screen.cu",
                                    "src/repro/kernels/screen.py:68"),
                "fused_screened_topk": ("src/repro_torch/csrc/fused_topk.cu",
                                        "src/repro/kernels/fused_topk.py:193"),
                "ssd_intra": ("src/repro_torch/csrc/ssd.cu",
                              "src/repro/kernels/ssd.py:70"),
                "ssd_intra_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                                  "src/repro/layers/ssm.py:116-125"),
                "cache_slot_update": ("src/repro_torch/csrc/cache_update.cu",
                                      "src/repro/kernels/cache_update.py:69")}
    for name in L2S_KERNELS:                  # their bfloat16 bodies
        replaces[name + "_bf16"] = replaces[name]
    kernels = []
    for name, (source, rep) in replaces.items():
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1],
                        "library_ms": t["library_ms"],
                        "launches_by_path": {p: n.get(name, 0)
                                             for p, n in paths.items()},
                        "launch_cost_ms": costs.get(name)})
        for key in ("unfused_ms", "single_ms", "two_single_ms",
                    "fma_bound_ms", "sass_hmma", "at_mamba2_chunk"):
            if key in t:
                kernels[-1][key] = t[key]
        for shape, row in dense_rows.get(name, {}).items():
            kernels[-1][shape] = {
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
                "library_ms": row["library_ms"],
                **({"unfused_ms": row["unfused_ms"]}
                   if "unfused_ms" in row else {})}
        if name == "fused_screened_topk_bf16":
            f = t["full_cover_k128"]
            kernels[-1]["full_cover_k128"] = {
                "B": 4, "K": 250, "k": 128, "d": ZD, "ms": f["ms"],
                "plain_ms": f["plain_ms"], "unfused_ms": f["unfused_ms"],
                "bound_ms": f["bound"][0], "bound_by": f["bound"][1],
                "library_ms": None, "parts": f["parts"]}
        if name in wide and name not in BF16_KERNELS:
            w = wide[name]
            kernels[-1]["at_zamba2_width"] = {
                "d": ZD, "ms": w["ms"], "plain_ms": w["plain_ms"],
                "bound_ms": w["bound"][0], "bound_by": w["bound"][1],
                "library_ms": w["library_ms"]}
            if "unfused_ms" in w:
                kernels[-1]["at_zamba2_width"]["unfused_ms"] = w["unfused_ms"]
        if name == "fused_screened_topk":
            r = shard_rows["shard"]
            kernels[-1]["at_gemma_vocab_shard"] = {
                **{k_: r[k_] for k_ in ("B", "K", "n_blk", "d", "k",
                                        "live_tiles", "ms", "plain_ms",
                                        "library_ms")},
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            kernels[-1]["sharded_heads"] = shard_rows["heads"]
            kernels[-1]["at_translation_batch"] = batch_rows
            kernels[-1]["adaptive_step"] = {
                str(d_): {"B": 4, **{f"{n}_ms": t_[0] for n, t_ in st.items()},
                          **{f"{n}_bound_ms": t_[1][0]
                             for n, t_ in st.items()}}
                for d_, st in ((D, steps_lstm), (ZD, steps_z))}
        if name == "screened_logits":
            kernels[-1]["at_beam_shape"] = [
                {"B": 20, "K": K, "d": d_, "ms": t_["ms"],
                 "plain_ms": t_["plain_ms"], "bound_ms": t_["bound"][0],
                 "bound_by": t_["bound"][1], "fused_ms": t_["fused_ms"]}
                for d_, t_ in zip((D, ZD), beam)]
    log(f"[done] chip_smoke.py took {time.perf_counter() - T_START:.1f} s, "
        f"the kernels' build included; phase walls (s): {json.dumps(WALLS)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
