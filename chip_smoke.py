#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (cafe_tpu_torch) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each printing one JSON line and raising on failure:

1. build + device: the kernels are compiled from the repo's .cu sources
   (one nvcc per source, all at once); the card's name and power limit;
2. kernels: K1 and K2 against their plain PyTorch versions on the card
   at the slice's shapes (K1 bit-exact, on its edge cases too: a
   20,000-lane run, empty row bands, no rows, every lane dropped; two
   launches bit-equal; K2 within its f32 bound), timed beside the plain
   version, one library call and the memory bound; K1 also inside a
   replayed CUDA graph of 20 calls (`graph_ms`);
3. headline: DLRM + CAFE, Criteo-Kaggle's 26 vocabularies, batch 2048,
   dim 16, cr 1e-3, bf16 towers, SGD, a sketch insert every step — timed
   eager steps through build_all(capture=False) / train_step; K1 must
   launch once per step (phases 3, 5, 7 and 8 drive the eager step, as
   before the steps were graphed; phases 17-21 the graphed one);
4. kernels_rowsum: K3 against its plain version at the headline table
   (27,136 x 16) with 53,248 lanes: the ids the trained CafePart routes
   a batch to, duplicate-heavy Zipf ids, and one row taking every kept
   lane (a run over 208 tiles) — within the f32 reordering bound of the
   longest run, bit-equal on dyadic payloads, and two launches bit-equal
   to each other; timed as phase 2, with each stage's device time (prep,
   sort, sum, fix-up) read by kernel name from a torch.profiler window;
5. headline_dense: the headline with --sparse_apply_impl dense; K1 and K3
   must each launch once per step;
6. parity: 3 headline steps on the card (build_all's default step: 2
   eager warm-up calls, then a captured CUDA graph) and on the CPU from
   one state
   (frequency scores, low threshold so ids promote), for the auto and the
   dense sparse apply: sketch and routing equal, loss / params / table
   within a stated tolerance;
7. sibling: the dim-128 config (cr 0.1, lr 1.0, CriteoTB towers on the
   Kaggle vocabularies; a 3.2M-row table) — K1 and K2 must launch;
8. profile: 5 headline steps (auto and dense) under torch.profiler —
   device busy time, idle share, kernels per step (tables in
   chiprun_out/); the landing must be one kernel a step (K1's
   land_max_kernel, no fill kernel);
9. cli (run after phase 21): main_torch.main, whose train and eval
   steps replay CUDA graphs, on a Criteo-Kaggle-shaped memmap in the
   reference's binary format (114,688 rows: 48 train and 8 test batches
   of 2048) with the headline flags, --sparse_apply_impl dense and an lr
   schedule: run A trains, evaluates twice and checkpoints (K1 and K3
   must launch 48 times, counted per replay); run B loads the best
   checkpoint into a graphed eval step and must reproduce run A's
   metrics there; run C measures the latency protocol;
10. kernels_a2a: K5 at n = 1 at the headline's exchange shapes (ids
   [1, 53,248] int32, rows [1, 53,248, 16] f32), bit-equal to its plain
   version (NCCL all_to_all_single) and timed beside it, `copy_` and the
   memory bound, and inside a replayed CUDA graph of 20 calls
   (`graph_ms`); K5's device all-gather and reduce-scatter (the rare
   legs inside the mesh steps' branch bodies) at n = 1, bit-equal to
   their plain versions, timed beside them, NCCL's all_gather_into_tensor
   / reduce_scatter_tensor and the bound; then K5 between 4 processes on
   the one card through CUDA IPC over 3 successive calls, and its device
   all-gather and reduce-scatter (one-owner rows) against their plain
   versions on the processes' gloo group, bit-equal on every rank (not
   timed: processes on one card without MPS are time-sliced);
11. sharded: the headline through build_all(mesh=make_mesh(1)) on NCCL
   with --shard_exchange pallas, timed as the headline (K5 must launch 4
   times and K1 once per step); the same state through explicit, a2a and
   pallas, and on the CPU (a gloo group of 1), 3 steps each with
   frequency scores: sketch and routing equal, tables within the bound;
   5 traced steps, the landing one kernel a step;
12. cli_sharded: main_torch.main on the memmap with --mesh_shape 1
   --shard_embeddings true --shard_exchange pallas, checkpointing: at
   --steps_per_dispatch 1 and 8 run A trains 48 steps with 2 evals and
   rolling saves of the global state, run B resumes from A's mid-run slot
   and must print A's losses at every common iteration; the latency
   protocol on the mesh; launch counts checked (K1, K3 once a step, K5 4
   times a step and twice an eval call);
13. kernels_gather (run right after kernels_rowsum): K4 against its plain
   version, bit for bit, at decision 4's shape (53,248 uniform ids into a
   4,194,304 x 128 f32 table), at the headline table (27,136 x 16) with
   the ids the trained CafePart routes a batch to, in bf16, on two
   unaligned views (4-byte words, bytes) and at B = tile; timed beside
   the plain version, index_select and the memory bound;
14. ab_decisions: the four decisions of tools/ab_decisions_torch.py in
   this process at full width, 2 windows x 20 steps: four report lines,
   K4 launched 10 + 3 x 20 times in decision 4, K1 once a step in
   decisions 1-3 and K2 once a step in decision 2; before them, the
   donate_off arm's multi-step must leave its input state unchanged;
15. ab_insert_land: tools/ab_insert_land_torch.py (level 1, the equal-state
   check of all four landing arms, level 2), 2 windows x 20 steps; only
   the pallas arm launches K1, once an insert;
16. roofline: cafe_tpu_torch.tools.roofline at its default shapes: K2
   launched by optimizer_apply, every frac_of_peak <= 1.05.
The tools' own prints go to OUT_DIR/tools_*.txt; the tools time eager
steps.

The compiled step (CUDA graphs, train/capture.py), run before phase 9:

17-19. headline_graph, headline_dense_graph, sibling_graph: the step of
   phases 3, 5 and 7 built graphed (it must report `.graphed`) and eager
   on one state, in alternating windows of 20 steps ended by a
   synchronize, 3 each: ms/step and windows of each, peak memory,
   capture time, and the launches a graphed step makes, counted per
   replay, which must equal what the capture recorded (K1 once; K3 or
   K2 once in dense and sibling). Then the gate `replay_equals_eager`,
   with frequency scores and a low threshold (ids promote) over 12
   batches with a tail and an empty one: from one start state the
   sketch, tick, step, promotions and routed rows bit-equal between the
   eager and the replayed trajectory (and, in dense, whose K3 apply is
   deterministic, the tables, params and metrics); and step by step from
   one cloned state every tensor and metric bit-equal, the tables
   bit-equal in dense and, in headline (index_add_) and sibling (K2),
   whose scatter-adds sum in float atomics, within twice the reordering
   bound of the step's scatter-add (each order within it of the exact
   sums), beside the gap between two eager steps;
20. eval_graph: the graphed eval step's scores equal the eager one's
   batch for batch, then alternating windows of 20 calls, 3 each;
21. profile_headline_graph: phase 8's trace of 5 replayed headline
   steps (device busy, idle share, kernels a step, one K1 a step);
22. cli_timing (after phase 9): main_torch.main graphed and eager, in
   turns, on a 458,752-row memmap (192 train batches) at
   --steps_per_dispatch 1 and 8: train ms/it from the printed 32-it
   windows after it 128 (its 160 and 192), and each one's latency protocol (eval ms/it);
   K1 and K3 once a step.

The baseline methods and the other towers, at full Kaggle width (run
after phase 16), each built through build_all and graphed (since
train/step.capture_blockers names nothing on one device; AdaEmbed's
check steps run eagerly on its graph's state):

23. methods: QR (add, mult, concat), MDE, Off (hot dictionaries from the
   batches' dataset), weighted pooling (hash, learned) and AE
   (--max_ind_range 65536, one batch of pretraining first) at the
   headline flags with --sparse_apply_impl dense; QR and AdaEmbed at the
   sibling's (dim 128, cr 0.1, lr 1.0; AdaEmbed's first step runs its
   check and rebuild over all 33.76 M ids: the admitted count and a
   rebuild's time). Each: 3 windows of 20 steps after the first step and
   the warm-up calls, ms/step, its own peak allocated memory, graphed or
   not, and the kernels it launched, each as often as the apply routes
   of ops/sparse.py predict (K3 per dense-apply table, K2 per table of
   >= 2^20 rows at dim 128); then K2 against its plain version at the
   sibling QR's q table and AdaEmbed's pool (lanes at n_rows included)
   and K3 at the headline QR's q and r tables and Off's table, with the
   rows each routes a batch to; then `card_vs_cpu`: 3 steps (2 warm-up
   calls and a replay) on the card and on the CPU, each from one state,
   with AE's pretraining first: integer state and routed rows equal,
   every scatter-added table within twice its reordering bound plus the
   lanes' card-vs-CPU gradient gap, other embedding state bit-equal,
   dense params within 1e-3 (bf16 towers), AE's pretrained tensors
   within 1e-5;
24. towers: WDL and DCN over CAFE at the headline flags (dense apply), as
   phase 23; the gate with frequency scores and a low threshold, so the
   sketch compares exactly;
25. cli_qr_dcn: main_torch.main --compress_method qr --model dcn at the
   headline flags on the CLI_ROWS memmap: 48 steps, 2 evals, K3 twice a
   step.

CAFE+, the two-tier sketch with the adaptive threshold (each at full
Kaggle width, graphed; K1 never launches on a CAFE+ path):

26-29. cafe_plus, cafe_plus_dense, cafe_plus_sibling, cafe_plus_reset
   (run after phases 17-19): the headline flags with --cafe_plus true
   (auto apply; dense apply: K3 once a replay), the sibling's (K2 once a
   replay), and the headline with frequency scores and threshold 1, so
   the reset fires every few steps. Each as phase 17 (eager and graphed
   windows, launches a replay, peak memory) beside v1's graphed ms/step
   of this call; how often the reset and the decay fired in those steps
   (a counter on the card, two compares and an add before each step, in
   both arms); the replay gate of phase 17 (frequency scores;
   the reset configuration keeps its threshold of 1, and its trajectory
   must see the reset fire); and `card_vs_cpu`, phase 23's gate (3
   steps, each from one state; the reset configuration 3 card steps in,
   where the reset fires);
30. plus_reset_cost_headline, plus_reset_cost_sibling: the insert at
   each shape, a call's share of 5 calls captured in a CUDA graph: the
   reset alone, the insert with its reset branch untaken, the insert
   taking it, the insert without the reset;
31. profile_cafe_plus_graph: phase 21's trace of 5 replayed CAFE+
   headline steps (no K1);
32. cli_plus (after phase 9): phase 9's runs A, B and C with
   --cafe_plus true (K3 48 times in run A, no K1);
33. sharded_plus, sharded_parity_plus (after phase 11): the sharded
   headline with --cafe_plus true at world size 1 (K5 4 times a step),
   and phase 11's parity (every CAFE+ sketch field equal in each mode
   and on the CPU);
34. sketch_bench (last): tools/sketch_bench_torch.py on a 60,000-id Zipf
   stream; CAFE+ recall above 0.6.

Quantized serving and the export (no kernel of ours on these paths: the
dequantizing lookup is torch's row gather and element-wise ops):

35. quant_parity (after phase 7): the trained headline table (27,136 x
   16) and sibling table (3,232,256 x 128) quantized on the card and on
   the CPU at 8 and 4 bits: codes byte-equal (a code one level apart is
   counted, one further apart fails), scale and zero bytes equal;
36. serving_quant, export (after phase 21): tools/serving_bench_torch.py
   at the headline shape (B = 2048) and its serving shape (dim 128, cr
   0.1, 16,384 rows): graphed f32, int8 and int4 eval steps in
   alternating windows, ms a call, the codes' bytes against the f32
   table, mean |p_f32 - p_q| < 0.01, and the A/B of the code-row
   gather's two forms at that shape (the tool's int8_plain arm routes
   without CAFE's frozen sketch view); then serving_packed: the frozen
   packed sketch view (CafePart.quantize_for_serving's sk_packed) at the
   headline flags after 8 steps, its route exactly the plain query's,
   its rows and graphed int8 scores bit-equal to the plain route's, the
   query alone timed plain, packed each call and frozen, and the A/B of
   the two routes at both shapes; then the headline eval exported
   from the card's state at B = 2048 (torch.export), loaded back and
   held against the eager eval step within 1e-5;
37. cli_quant (with phase 9): run A's best checkpoint served with
   --inference_only --quantize_emb_bits 8, then 4: the scores main_torch
   computed held against run B's float ones (mean |dp| < 0.01, max |dp|
   < QUANT_MAX) and the accuracy within 0.01; the same in cli_plus
   (CAFE+, its "quant"), and cli_sharded serves its own run A's best
   checkpoint at f32, 8 and 4 bits on the world-size-1 mesh under the
   same gates, and at f32 on one device without a mesh (the 1-shard
   layout), whose scores must equal the mesh's within 1e-6;
38. sharded_quant (after phase 33), v1 and CAFE+: the quantized eval
   step on the world-size-1 NCCL mesh (eager) and the same state on one
   device through enable_sharded_layout(1) (graphed): scores bit-equal.

The graph recommenders (main_graphrec_torch.py, whose steps replay CUDA
graphs on the card; after phase 12; each phase prints its wall time):

39. graphrec_lightgcn: LightGCN at the reference's width (dim 64, 3
   layers, Adam lr 0.001, weight decay 1e-4, cr 0.1, hot rate 0.7, B =
   2048) on a synthetic graph of Gowalla's size (29,858 users, 40,981
   items): an epoch at the default threshold 500 (its hot ids), then at
   LIGHTGCN_THRESHOLD an epoch saved and a run that auto-resumes and
   trains one more: ms a step behind a synchronize, the host's negative
   sampling apart, recall@20 above a random ranking's, hot ids, K1 once
   a step; each run's step graphed, K1's launches inside graphs equal
   to its replays (graphrec_graph_gate); K1 on the inputs a step of
   the trained state gives it, bit-equal to its plain version and
   timed; one step from that state on the card and on the CPU
   (frequency scores): sketch and tick exact, table and Adam slots
   within adam_close; then GRAPHREC_GRAPH_STEPS steps graphed beside
   eager from that state on one batch (graphed_beside_eager): ms a step
   of each, capture s, launches a replay, K1 inside graphs, peak
   allocated memory and the graph's private pool; sketch, tick and hot
   ids exact, table and Adam
   slots within adam_close; beside them the step graphed with its sums
   in float atomics (atomic_sums: as before segment_rows), its ms a step
   in the same windows; two more graphed runs of 20 steps from one
   state bit-equal; K3 (segment_rows: the message sums, the gathers'
   backward, the apply) 7 times a step, inside graphs 7 times a replay,
   and on the inputs one step gave it against its plain version and
   timed (rowsum_case); the graphed step traced;
40. graphrec_pinsage: PinSAGE at the reference's width (hidden 16, 2
   layers, T = 3, 10 walks, Adam) with CAFE (compress ratio 4) on a
   synthetic graph of MovieLens-1M's size (6,040 x 3,706), B = 2048
   (79,872 padded ids a step), PINSAGE_STEPS steps an epoch: train and
   save, auto-resume and train one more, hit@10 and NDCG; the host
   sampler timed apart from the device step; K1 once a step, the graph
   gate (the representation step graphed too), its case, the
   card-against-CPU step and the graphed-beside-eager steps as phase 39
   (conv params and their Adam slots within GRAPHREC_TOL; K3 4 times a
   train step: the three position gathers' backward and the apply), the
   free run's floats held and also step by step (graphed_lockstep: each
   replay from the eager step's input state);
   represent_items through the graphed representation step against the
   eager one on one state within GRAPHREC_TOL (bit-equal expected).

QR, Off and AdaEmbed on the mesh, and the unique-compact exchange (world
size 1, after phase 12; eager steps; each line carries its wall time):

41. sharded_methods: QR (add, mult, concat) and Off at the headline flags
   (dense apply) and AdaEmbed at the sibling's, sharded, each in the
   explicit, a2a and pallas modes on the card, 2 steps, each from the
   pallas run's state before it: integer state, routing and AdaEmbed's
   admitted counts equal, tables, loss and dense params within DENSE_TOL
   of the pallas run's step; the pallas
   mode against the CPU's through phase 23's `card_vs_cpu` gate on two
   meshes of one rank; then ms/step (2
   windows of 5), the exchange's device time a step (CUDA events around
   parallel/exchange.py's calls, less the optimizer apply in them) and
   its share, K2 / K3 launched as the apply routes predict and K5 as
   predicted_a2a counts the parts' pallas legs;
42. sharded_methods_unique_compact: hash and CAFE v1 (frequency scores)
   under the explicit exchange with --shard_unique_frac 0.5 (every leg
   takes the compact branch) and 0.1 (every leg overflows to the
   full-size branch), each against the full-size run from one state:
   loss within 1e-5 relative, tables within COMPACT_TOL, the sketch
   equal; the branches a step took; ms/step;
43. sharded_methods_cli_qr: main_torch.main --compress_method qr
   --mesh_shape 1 --shard_embeddings true --shard_exchange pallas: run A
   trains with 2 evals and rolling saves, run B resumes from its mid-run
   slot with A's losses, the best checkpoint served at f32 and int8 on
   the mesh (score_gate); K3 twice and K5 4 times a step.

The rest of the mesh (world size 1, after phase 43; eager steps):

44. sharded_auto: --shard_exchange auto at the headline flags (index_add_
   apply), with the dense apply (K3) and at the sibling's (K2): against
   one card's single-device step, SHARDED_GATE_STEPS steps each from one
   state (gate_auto_single: integer state, promotions and routing exact,
   the scatter-added tables within twice their reordering bound, other
   float leaves bit-equal), the headline's card_vs_cpu (phase 23's gate
   on two meshes of one rank); ms/step, the exchange's device share, K1
   once a step (K3, K2 once in dense, sibling) and the layout's bytes
   (sharded tables against what every rank holds whole);
45. sharded_two_level: the (1, 1) two-level mesh (--mesh_inner 1): CAFE
   v1 (frequency scores) against the flat mesh from one state
   (promotions, sketch and routing exact), ms/step and the exchange's
   share beside the flat run's; hash with --shard_unique_frac 0.5
   (compact) and 0.1 (full-size) on it, as phase 42;
46. cli_auto: phase 43's runs (train, resume, serve f32 and int8) of the
   headline CLI under --shard_exchange auto and with --mesh_inner 1; K1
   and K3 once a step;
47. wire_audit: cafe_tpu_torch.tools.wire_audit in this process on the
   CLI memmap (explicit, --mesh_inner 1, auto): every collective under
   the O(batch) bound; its tables in OUT_DIR/tools_wire_audit.txt.

The data and experiment tools (after phase 34; eager and graphed as
their entry points build them; each line carries its wall time):

48. preprocess_cli: a 131,072-row Kaggle-format TSV (label, 13 dense, 26
   hex categoricals, missing cells) through cafe_tpu_torch.data.preprocess
   and native.NativeEncoder, one after the other and each timed alone:
   counts, labels and dense floats byte-equal,
   the native sparse ids the Python ids relabelled in first-seen order
   (native/encoder.cpp numbers tokens as it meets them); then
   main_torch.main one epoch on the preprocessed memmap (CAFE, cr 1e-3,
   dense apply) with its evaluation: K1 and K3 once an iteration, a
   finite AUC;
49. job_scheduler: a task file on that data with a hash section and a
   CAFE section pairing two compress rates with two thresholds, 3 tasks
   through cafe_tpu_torch.tools.job_scheduler.schedule (main_torch.py
   processes on the card, 3 workers): every return code 0, each run's
   config.json, stdouterr.log and scalars.jsonl, and visualization's
   collect_method_runs / run_summary read an AUC back for each run;
50. criteo_grid: cafe_tpu_torch.tools.criteo_grid.main on 262,144 rows of
   the Criteo-scale stream, one epoch, full, hash and CAFE at cr 1e-3,
   then CAFE at cr 0.1, into OUT_DIR/criteo_grid_torch.jsonl: 4 records
   of 109 steps, 0.5 < AUC <= 1, slots_used <= slot_capacity, K1 109
   times a CAFE config, and the first call again skipping each record;
   each config's train_s, ex_per_s, AUC and peak memory; card against
   CPU for hash and CAFE (frequency scores) at cr 1e-3 over
   GRID_GATE_STEPS steps (phase 23's gate); K1 on the inputs an eager
   CAFE step at cr 0.1 gives it (its largest bucket count), timed;
51. graphrec_interactions: an events CSV (2,000 users x 1,000 items,
   60,000 events) split by cafe_tpu_torch.tools.process_interactions (the
   last event of each user held out), then LightGCN with CAFE one epoch
   through main_graphrec_torch.main --data_path: one test item a user, K1
   once a step, the step graphed (graphrec_graph_gate), a finite
   recall@20.

The repo's root measurement tools and a dataset launcher (after phase
51; each tools/*_torch.py in this process at its JAX twin's shapes, cut
to TOOL_WINDOWS windows of TOOL_STEPS steps; their prints go to
OUT_DIR/tools_*.txt; every reading must be finite and positive):

52. latency_grid: the reference's latency protocol (hash, QR, MDE,
   AdaEmbed, CAFE at the CriteoTB towers, dim 128, cr 0.1, train batch
   2048, test batch 16,384): the JAX record's keys, every method
   graphed, each method's K1 / K2 launches as its apply routes
   predict (predicted_launches) times the steps taken, its own peak
   memory, every latency.json read back through
   visualization.plot_latency (a recording stand-in for matplotlib
   where the machine has none), and K2 held against its plain version
   on each method's first eager inputs that land a lane;
53. step_breakdown: both grids (criteo: cafe, cafe_iv8, hash, full at
   dim 16; criteotb: cafe, hash at dim 128), each arm and its forward
   arm eager and graphed (cafe_iv8 too: its skipped inserts are
   conditional nodes); K1 once a CAFE train step (once an insert that
   ran at cafe_iv8), K2 once a train step at dim 128;
54. profile_step: 5 graphed K = 8 dispatches under torch.profiler, the
   replays traced (no fall-back to the eager step); 40 of K1's land_max
   kernels among the device ops;
55. profile_train: 4 eager steps, device time by source line; the lines
   hold at least the tool's MIN_ATTRIBUTED of the device-busy time;
56. variance_cafe_vs_hash: three seeds at full size, graphed; finite AUCs,
   K1 once a CAFE step, and K1 held on its first eager inputs;
57. sweep_cafe_vs_hash: the sweep's first two grid points (two seeds
   each), as phase 56;
58. ab_apply128: K2 within its numerics bound, then index_add_ fresh, in
   place and K2 at the CriteoTB and dim-16 shapes, each arm's window
   one replayed CUDA graph of its chain; K2 once a call, and held
   against its plain version on each level's first inputs;
59. ab_interact: the four interaction arms, each chain one CUDA graph,
   within the bf16 bound of their exact products, their kernels named;
60. ab_scatter_vs_sorted (--sparse_apply_impl dense): the full-table pass
   against the scatter at the CAFE table, the big-table scatter; K3
   once an SGD scatter call;
61. reset_cost: CAFE+'s insert at lim 1,000,000 with its reset branch
   untaken, taken every call, and absent, graphed; the fires of a
   100-step Zipf stream;
62. probes: kernel_overhead_probe (eager and graphed), micro_ops (one
   graph, split by marker kernels), clock_probe (at most 1.05 of the
   bf16 peak);
63. launcher_criteo_kaggle: bench/criteo_kaggle_torch.sh on phase 48's
   preprocessed data, $1 capping it at 220 iterations of 1024 rows
   (CAFE, cr 1e-3, dense apply): exit 0 and a finite AUC.

The last root tools, after phase 63:

64. traffic_table: tools/traffic_table_torch.py's rows at world size 1,
   hash and CAFE, on the card (NCCL) and on the CPU (a gloo group) in
   this process: both record the same total and the same bytes by op
   (the configuration sets them, not the backend), each row within the
   JAX tool's criterion wherever the model is non-zero; K1 launches once
   (the card's CAFE step) and is held, bit-equal, against its plain
   version on the inputs that step gave it;
65. perf_report: tools/perf_report_torch.py over this run's OUT_DIR:
   SUMMARY.md holds the clock, headline, stage-budget and decisions
   sections, the clock reads VALID and the headline's ms a step is
   headline_graph's.

The device branches and the benchmark's twin:

66. cond_capture (after phase 30): each configuration of cond_configs
   (CAFE v1 at the headline width at interval 8 and 2, CAFE+ at
   cafe_plus_reset's flags, hash with Adagrad and with Adam at the
   headline width and cr 0.1, AdaEmbed at the latency grid's width from
   step 16,380) eager and
   graphed from one bridged state over 16 steps: integer state
   bit-equal, floats within DENSE_TOL, K1 launched once an insert that
   ran, every call replayed but AdaEmbed's check step, CAFE+'s reset
   taken inside a replay; then 16 timed steps each, ms a step;
67. bench_torch (after phase 64): bench_torch.main at one short window
   (its measure of the headline and the three extras): bench.py's keys
   plus "device" and "graphed", every rate positive and graphed, MFU in
   (0, 1]; K1's launches, all and in graphs, equal to the inserts the
   four configurations ran (interval 8's warm-up spares included), and
   K1 held against its plain version at each configuration's first
   insert (cr 1e-4 and dim 128 are shapes of their own; other_paths).

Then the kernels line (every kernel's launches on the main path, those
made by graph replays and those inside branch bodies, error, times,
bound and, for K1 and K5, graph_ms; K1's and K2's cases at the other
paths' shapes under "other_paths", K5's device collectives under
"collectives")
and, last, the device line. Every JSON line carries `elapsed_s`, the
seconds since the script started.
Exits non-zero without a CUDA card or without the cafe_tpu_torch package
beside it.
"""

import contextlib
import dataclasses
import gc
import io
import itertools
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
HEADLINE_STEPS, WINDOWS = 20, 5
SIBLING_STEPS = 5
OUT_DIR = "chiprun_out"
CLI_ROWS = 114688             # 6/7 train: 48 batches of 2048; 8 test ones
CLI_TIMING_ROWS = 458752      # 192 train batches of 2048; 32 test ones
CLI_FLAGS = ["--dataset", "criteo", "--embedding_dim", "16",
             "--compress_method", "cafe", "--compress_rate", "0.001",
             "--cafe_sketch_threshold", "500", "--cafe_hash_rate", "0.5",
             "--mini_batch_size", "2048", "--learning_rate", "0.1",
             "--bf16", "true", "--sparse_apply_impl", "dense",
             "--test_mini_batch_size", "2048"]


T0 = time.perf_counter()

# uniform draws of at least this many values (the tables' inits) are
# memoised, up to MEMO_DRAW_BYTES of them (_MemoDraws)
MEMO_DRAW_MIN, MEMO_DRAW_BYTES = 1 << 24, 16 << 30


class _MemoDraws(np.random.Generator):
    """A numpy Generator whose large uniform draws are memoised by the
    generator's state and arguments: a configuration built again (the
    phases build the sibling's 3.2 M-row tables some thirty times) takes
    its draws from memory, bit-equal, and leaves the generator where the
    draw would have left it. The memo's arrays are read-only; the oldest
    go first past MEMO_DRAW_BYTES."""

    _memo: dict = {}

    def uniform(self, low=0.0, high=1.0, size=None):
        n = int(np.prod(size)) if size is not None else 1
        if n < MEMO_DRAW_MIN:
            return super().uniform(low, high, size)
        key = (repr(self.bit_generator.state), np.asarray(low).tobytes(),
               np.asarray(high).tobytes(), repr(size))
        hit = self._memo.pop(key, None)
        if hit is None:
            out = super().uniform(low, high, size)
            out.flags.writeable = False
            hit = (out, self.bit_generator.state)
        self._memo[key] = hit               # the newest last
        while sum(a.nbytes for a, _ in self._memo.values()) \
                > MEMO_DRAW_BYTES and len(self._memo) > 1:
            self._memo.pop(next(iter(self._memo)))
        self.bit_generator.state = hit[1]
        return hit[0]


def memo_table_draws() -> None:
    """np.random.default_rng returns a _MemoDraws over the generator it
    would have made (the same bit generator and draws)."""
    make = np.random.default_rng
    if getattr(make, "memo", False):
        return

    def default_rng(seed=None):
        return _MemoDraws(make(seed).bit_generator)

    default_rng.memo = True
    np.random.default_rng = default_rng


def cpu_copy(tree):
    """A CPU copy of a state tree (one device-to-host copy a tensor;
    other leaves shared)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    if hasattr(tree, "_fields"):
        return type(tree)(*(cpu_copy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_copy(v) for v in tree)
    return tree


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started, on
    stdout and appended to OUT_DIR/chip_smoke.jsonl (the whole run: a
    caller may keep only the end of stdout)."""
    line = json.dumps({**obj, "elapsed_s": time.perf_counter() - T0})
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


def time_ms(fn, reps=30, warmup=3) -> float:
    """Median device time of fn() over `reps` runs, CUDA events. Each run
    is queued behind a ~0.5 ms device sleep, so the events time the
    device's work and not the host's launch latency (a function that
    waits for the device inside, like a boolean-mask index, still
    includes its own wait)."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_ms(fn, reps=30) -> float:
    """Host time of one fn() call while the device is kept busy (the
    wrapper's own cost: checks, allocation, the ctypes launch)."""
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def graph_ms(fn, calls=20, reps=10) -> float:
    """Per-call device time of `calls` fn() calls captured in one CUDA
    graph: median over `reps` replays, each queued behind a device sleep
    and timed with events around the replay. A capture that fails
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from cafe_tpu_torch.utils.cond import capturing
    graph = torch.cuda.CUDAGraph()
    # a cond in fn becomes a conditional node of this graph
    with capturing(graph, torch.device("cuda", torch.cuda.current_device())
                   ), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    return float(np.median([s.elapsed_time(e) for s, e in ev])) / calls


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def land_case(rng, b, c, n, kind="random"):
    if kind == "all_dropped":            # below 0 and at or past n
        keys = np.concatenate([rng.integers(-60, 0, b // 3),
                               rng.integers(n, n + 50, b - b // 3)])
    elif kind == "key_eq_n":
        keys = np.concatenate([rng.integers(0, n, b - 8), np.full(8, n)])
    elif kind == "sparse_rows":
        keys = rng.choice(np.arange(0, n, 7), b)
    elif kind == "band":                 # empty rows before and after
        keys = rng.integers(n // 3, 2 * n // 3, b)
    elif kind == "hot_run":              # one row takes 20,000 lanes
        keys = np.concatenate([rng.integers(0, n, b - 20000),
                               np.full(20000, n // 2)])
    elif kind == "rows_zero":            # n == 0: every lane dropped
        keys = rng.integers(-5, 50, b)
    else:
        keys = rng.integers(0, n + 7, b)
    keys = np.sort(keys).astype(np.int32)
    enc = np.where(rng.random((b, c)) < 0.6,
                   rng.integers(0, 1 << 30, (b, c)), -1).astype(np.int32)
    return torch.from_numpy(keys).cuda(), torch.from_numpy(enc).cuda()


def phase_kernels(land, scatter_add):
    rng = np.random.default_rng(0)
    out = {}
    # ---- K1: both slice shapes + the edge cases of the card tests
    k1 = []
    for b, c, n, kind in [(53248, 5, 9646, "random"),
                          (36864, 5, 1543432, "random"),
                          (100, 4, 128, "random"), (512, 2, 64, "all_dropped"),
                          (333, 5, 97, "key_eq_n"),
                          (256, 3, 4096, "sparse_rows"),
                          (30000, 5, 5000, "hot_run"),
                          (4096, 5, 200000, "band"),
                          (777, 5, 0, "rows_zero")]:
        keys, enc = land_case(rng, b, c, n, kind)
        got = land.land_max(enc, keys, n)
        again = land.land_max(enc, keys, n)
        want = land.land_max_plain(enc, keys, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if n else 0
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{(b, c, n, kind)}: max err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"K1: two launches differ at "
                                 f"{(b, c, n, kind)}")
        row = {"shape": [b, c, n], "kind": kind, "max_abs_err": err,
               "two_launches_equal": True}
        if kind == "random":
            out_lib = torch.full((n, c), -1, dtype=torch.int32,
                                 device="cuda")
            keep = (keys >= 0) & (keys < n)
            idx = keys[keep].long()[:, None].expand(-1, c).contiguous()
            src = enc[keep].contiguous()
            bms, by = bound_ms((b * c + b + n * c) * 4, b * c)
            row.update(
                ms=time_ms(lambda: land.land_max(enc, keys, n)),
                graph_ms=graph_ms(lambda: land.land_max(enc, keys, n)),
                host_ms=host_ms(lambda: land.land_max(enc, keys, n)),
                plain_ms=time_ms(lambda: land.land_max_plain(enc, keys, n)),
                library_ms=time_ms(lambda: out_lib.scatter_reduce_(
                    0, idx, src, "amax", include_self=True)),
                bound_ms=bms, bound_by=by)
        k1.append(row)
    out["land_max"] = k1
    emit({"phase": "kernels_land_max", "cases": k1})

    # ---- K2: the sibling's table with Zipf ids, duplicate groups > 1000
    n, d, b = 3232256, 128, 36864
    ranks = (rng.random(b) ** 6 * n).astype(np.int64)
    ids = ((ranks * 1000000007) % n).astype(np.int32)
    ids[rng.choice(b, 24, replace=False)] = -1          # dropped lanes
    ids[rng.choice(b, 24, replace=False)] = n
    table0 = torch.rand((n, d), generator=torch.Generator().manual_seed(1))
    table0 = (table0 - 0.5).cuda()
    upd = torch.from_numpy(
        rng.normal(0, 0.01, (b, d)).astype(np.float32)).cuda()
    row = scatter_add_case(scatter_add, table0, torch.from_numpy(ids).cuda(),
                           upd)
    if row["max_group"] <= 1000:
        raise AssertionError(f"K2 oracle needs a group > 1000 lanes, "
                             f"got {row['max_group']}")
    del table0
    out["scatter_add"] = row
    emit({"phase": "kernels_scatter_add", **row})
    return out


def scatter_add_case(scatter_add, table, ids, upd):
    """K2 against its plain version on one input (dropped lanes below 0
    and at or past the table's rows allowed): within the worst-case f32
    reordering bound, bit-equal on dyadic payloads; timed beside the
    plain version, index_add_ and the memory bound. Raises on a
    disagreement."""
    n, d = table.shape
    b = ids.shape[0]
    keep = (ids >= 0) & (ids < n)
    _, group_sizes = torch.unique(ids[keep], return_counts=True)
    g_max = int(group_sizes.max()) if group_sizes.numel() else 0
    uniq = int(group_sizes.numel())
    before = scatter_add.KERNEL.launches
    got = scatter_add.scatter_add_(table.clone(), ids, upd)
    if scatter_add.KERNEL.launches != before + 1:
        raise AssertionError("K2: the wrapper did not launch the kernel")
    want = scatter_add.scatter_add_plain_(table.clone(), ids, upd)
    err = float((got - want).abs().max())
    # worst-case f32 reordering bound: each of the g_max adds of a group
    # can round by 2^-24 of the running sum, at most |row| + sum |upd|
    tol = g_max * 2.0 ** -24 * (float(table.abs().max())
                                + g_max * float(upd.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K2 differs from its plain version at "
                             f"{(n, d, b)}: {err} > {tol}")
    del got, want
    # the same ids with dyadic payloads (multiples of 2^-10, every row's
    # running sum far below 2^14): f32 adds them exactly in any order, so
    # the kernel must match bit for bit, and a lost or doubled update
    # cannot hide under the reordering bound above
    table_q = torch.round(table * 1024) / 1024
    upd_q = torch.round(upd * 1024) / 1024
    got = scatter_add.scatter_add_(table_q.clone(), ids, upd_q)
    want = scatter_add.scatter_add_plain_(table_q, ids, upd_q)
    err_exact = float((got - want).abs().max())
    if err_exact != 0.0:
        raise AssertionError(f"K2 differs from its plain version on exact "
                             f"dyadic sums at {(n, d, b)}: {err_exact}")
    del got, want, table_q, upd_q
    lib_ids, lib_upd = ids[keep].long(), upd[keep].contiguous()
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    work = table.clone()
    row = {"shape": [n, d, b], "max_group": g_max, "distinct_rows": uniq,
           "dropped_lanes": int(b - int(keep.sum())),
           "lanes_at_n_rows": int((ids == n).sum()),
           "max_abs_err": err, "tolerance": tol,
           "max_abs_err_dyadic": err_exact,
           "ms": time_ms(lambda: scatter_add.scatter_add_(work, ids, upd)),
           "host_ms": host_ms(
               lambda: scatter_add.scatter_add_(work, ids, upd)),
           "plain_ms": time_ms(
               lambda: scatter_add.scatter_add_plain_(work, ids, upd)),
           "library_ms": time_ms(
               lambda: work.index_add_(0, lib_ids, lib_upd)),
           "bound_ms": bms, "bound_by": by}
    del work
    return row


def headline_cfg(Config, **kw):
    base = dict(dataset="criteo", model="dlrm", embedding_dim=16,
                compress_method="cafe", compress_rate=0.001,
                cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                mini_batch_size=2048, learning_rate=0.1, optimizer="sgd",
                bf16=True, cafe_insert_interval=1)
    base.update(kw)
    return Config(**base)


def drive(build_all, fence, cfg, data, batches, kernels, steps, windows,
          device="cuda", mesh=None):
    """Build the EAGER step on `device` (or on `mesh`), reset the kernel
    counts, run 2 warm-up steps and `windows` timed windows of `steps`
    steps, each ended by the port's fence (a device synchronize); return
    (state, embed, phase record). The graphed steps: phase_graph."""
    _, embed, state, step, _ = build_all(cfg, data, device=device,
                                         mesh=mesh, capture=False)
    fence(state)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    n_run = 0
    for i in range(2):
        state, m = step(state, *batches[i % len(batches)])
        n_run += 1
    fence(state, m)
    win_ms, promos = [], 0
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = step(state, *batches[n_run % len(batches)])
            n_run += 1
            promos += m["cafe_promotions"]
        fence(state, m)
        win_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    launches = {name: k.launches for name, k in kernels.items()}
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    ms = float(np.median(win_ms))
    return state, embed, {
        "steps": n_run, "ms_per_step": ms, "window_ms": win_ms,
        "examples_per_s": cfg.mini_batch_size * 1e3 / ms, "loss": loss,
        "promotions": int(promos), "hot_frac": float(m["cafe_hot_frac"]),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                        if device == "cuda" else None),
        "launches": launches,
        "parts": [type(p).__name__ for p in embed.parts]}


def phase_parity(build_all, from_reference, to_numpy, Config, data,
                 batches_cpu, batches_gpu, impl):
    """3 headline steps on the card and on the CPU from one state, with
    sparse apply `impl` (auto: index_add_; dense: K3 on the card, its
    plain version on the CPU)."""
    cfg = headline_cfg(Config, cafe_use_freq=True, cafe_sketch_threshold=2.0,
                       sparse_apply_impl=impl)
    _, c_embed, c_state, c_step, _ = build_all(cfg, data, device="cpu")
    _, g_embed, _, g_step, _ = build_all(cfg, data, device="cuda")
    g_state = from_reference(c_state, "cuda")
    rec = {"max_abs_diff": {}}
    for i in range(3):
        c_state, cm = c_step(c_state, *batches_cpu[i])
        g_state, gm = g_step(g_state, *batches_gpu[i])
    c, g = to_numpy(c_state), to_numpy(g_state)
    csk, gsk = c["embed"]["part0"]["sketch"], g["embed"]["part0"]["sketch"]
    for f in ("val", "cnt", "dic", "free", "free_top", "tot"):
        if not np.array_equal(csk[f], gsk[f]):
            raise AssertionError(f"sketch {f} differs between card and CPU")
    _, c_aux = c_embed.gather(c_state.embed, batches_cpu[0][1])
    _, g_aux = g_embed.gather(g_state.embed, batches_gpu[0][1])
    if not torch.equal(c_aux["part0"][1], g_aux["part0"][1].cpu()):
        raise AssertionError("routed rows differ between card and CPU")
    # bf16 towers: both round operands to bf16 and multiply in f32; the
    # f32 sums run in other orders, so a value can land one bf16 ulp
    # apart and move later grads by ~0.4%. Over 3 steps at lr 0.1 that
    # stays well below 1e-3.
    tol = 1e-3
    pairs = [("loss", float(cm["loss"]), float(gm["loss"])),
             ("table", c["embed"]["part0"]["table"],
              g["embed"]["part0"]["table"])]
    for tower in ("bot", "top"):
        for j, (cl, gl) in enumerate(zip(c["params"][tower],
                                         g["params"][tower])):
            for k in ("w", "b"):
                pairs.append((f"{tower}{j}.{k}", cl[k], gl[k]))
    for name, cv, gv in pairs:
        diff = float(np.max(np.abs(np.asarray(cv) - np.asarray(gv))))
        rec["max_abs_diff"][name] = diff
        if not diff <= tol:
            raise AssertionError(f"{name} differs by {diff} > {tol}")
    rec.update(impl=impl, tolerance=tol,
               promotions_cpu=int(cm["cafe_promotions"]),
               hot_frac=float(gm["cafe_hot_frac"]), sketch_equal=True,
               routing_equal=True)
    return rec


def phase_profile(build_all, cfg, data, batches, name, mesh=None,
                  capture=False, landings=1):
    """Trace 5 steps of `cfg` (eager, or with `capture` the replayed
    graph: 3 calls before the window warm it up and capture it); write
    the kernel table to OUT_DIR. A step must run `landings` K1 kernels
    (1 for the v1 sketch, 0 for CAFE+) and no fill kernel."""
    _, _, state, step, _ = build_all(cfg, data, device="cuda", mesh=mesh,
                                     capture=capture)
    if capture and not step.graphed:
        raise AssertionError(f"profile {name}: the step is not graphed")
    for i in range(3):
        state, _ = step(state, *batches[i])
    held = [state]

    def one(i):
        held[0], _ = step(held[0], *batches[i % len(batches)])

    return trace_steps(name, one, landings=landings)


# K1's old fill pass (`fill_kernel` of an earlier land.cu) as the profiler
# names it: whole, after a namespace (`(anonymous namespace)::`, as
# land.cu's kernels are named) or the return type; torch's own kernels
# carry the word inside theirs (masked_fill_kernel)
FILL_KERNEL = re.compile(r"(?<!\w)fill_kernel\b")


def check_fill_pattern():
    """FILL_KERNEL finds the fill pass under every name the profiler
    may give it, and none of torch's kernels."""
    cases = [("void (anonymous namespace)::fill_kernel<5>(int)", True),
             ("void fill_kernel<5>(int*, int)", True),
             ("fill_kernel", True),
             ("void at::native::(anonymous namespace)::masked_fill_kernel"
              "<bool>(at::TensorIterator&)", False),
             ("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::FillFunctor<float>>(int, ...)", False),
             ("void (anonymous namespace)::land_max_kernel<5>(int)", False)]
    wrong = [n for n, want in cases if bool(FILL_KERNEL.search(n)) != want]
    if wrong:
        raise AssertionError(f"the fill-kernel pattern misreads {wrong}")


def trace_steps(name, one, steps=5, landings=1):
    """Trace `steps` calls one(i) (warmed up by the caller) under
    torch.profiler: device busy ms and idle share a step, kernels a
    step, the top kernels; the kernel table goes to OUT_DIR. A step must
    run `landings` K1 kernels and no fill kernel."""
    from torch.profiler import ProfilerActivity, profile
    check_fill_pattern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            one(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    # device kernels only (aten ops also carry their kernels' time)
    dev = [(a.key, getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0)), a.count)
           for a in avgs if a.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted([x for x in dev if x[1] > 0], key=lambda x: -x[1])
    busy_us = sum(x[1] for x in dev)
    ours = [x for x in dev if "land_max_kernel" in x[0]
            or FILL_KERNEL.search(x[0])
            or "scatter_add_kernel" in x[0]
            or "rowsum_" in x[0] or "cafe_rowsum" in x[0]
            or "a2a_send_kernel" in x[0]]
    # the v1 sketch insert's landing: K1's one kernel a step, no fill pass
    landing = sum(c for k, _, c in dev if "land_max_kernel" in k) / steps
    fills = [k for k, _, _ in dev if FILL_KERNEL.search(k)]
    if landing != landings or fills:
        raise AssertionError(f"profile {name}: {landing} landing kernels a "
                             f"step (want {landings}), fill kernels {fills}")
    os.makedirs(OUT_DIR, exist_ok=True)
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(avgs.table(sort_by=key, row_limit=60))
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if dev else None,
            "kernels_per_step": sum(x[2] for x in dev) / steps,
            "landing_kernels_per_step": landing,
            "top_kernels": [{"name": k[:80],
                             "ms_per_step": t / steps / 1e3,
                             "calls_per_step": c / steps}
                            for k, t, c in dev[:10] + ours]}


GRAPH_STEPS, GRAPH_WINDOWS = 20, 3
# the replay gates' 12 batches: full ones, a tail and an empty batch
GATE_VALIDS = [2048, 2048, 2048, 2048 - 301, 2048, 0, 2048, 2048, 2047,
               2048, 2048, 2048]


def _order(windows):
    """Eager and graphed windows in turns, each pair's order flipped:
    e g g e e g ..."""
    return [m for w in range(windows)
            for m in (("eager", "graphed") if w % 2 == 0
                      else ("graphed", "eager"))]


def phase_graph(build_all, build_train_step, warmup_calls, fence, cfg, data,
                batches, kernels, steps=GRAPH_STEPS, windows=GRAPH_WINDOWS,
                per_replay_want=None, counter=None):
    """The eager and the graphed train step of `cfg` on one state, in
    alternating windows of `steps` steps that end in a synchronize:
    ms/step (median of `windows` each, and the windows), peak memory
    (and what was allocated before the build),
    capture time, and the kernel launches a graphed step counted per
    replay, which must equal what its capture recorded and
    `per_replay_want` (default: K1 once). With `counter` (fire_counter),
    its hook runs before every step and its count is the record's
    `fires`."""
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    model, embed, state, g_step, _ = build_all(cfg, data, device="cuda")
    if not g_step.graphed:
        raise AssertionError(f"{cfg.embedding_dim}-dim step not graphed: "
                             f"{g_step.capture_blockers}")
    before_step, read_fires = counter(embed) if counter else (None, None)
    e_step = build_train_step(model, embed, cfg, capture=False)
    steppers = {"eager": e_step, "graphed": g_step}
    n = 0

    def run(step, count):
        nonlocal state, n
        for _ in range(count):
            if before_step is not None:
                before_step(state)
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        return m

    for k in kernels.values():
        k.launches = 0
    run(g_step, warmup_calls + 1)          # warm-up calls, then capture
    run(e_step, 2)
    per_replay = g_step.launches_per_replay()
    times = {"eager": [], "graphed": []}
    peak = {"eager": [0, 0], "graphed": [0, 0]}
    graphed_launches = {name: 0 for name in kernels}
    for mode in _order(windows):
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = run(steppers[mode], steps)
        times[mode].append((time.perf_counter() - t0) * 1e3 / steps)
        peak[mode] = [max(peak[mode][0], torch.cuda.max_memory_allocated()),
                      max(peak[mode][1], torch.cuda.max_memory_reserved())]
        if mode == "graphed":
            for name, k in kernels.items():
                graphed_launches[name] += k.launches - before[name]
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    per_step = {name: v / (windows * steps)
                for name, v in graphed_launches.items() if v}
    if per_step != {name: float(v) for name, v in per_replay.items()}:
        raise AssertionError(f"graphed launches a step {per_step} differ "
                             f"from the capture's {per_replay}")
    want = per_replay_want or {"land_max": 1}
    if any(per_replay.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"launches a replay {per_replay}, want {want}")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    return {"graphed": True, "steps": n, "windows": windows,
            "steps_per_window": steps,
            "eager_ms_per_step": med["eager"],
            "graphed_ms_per_step": med["graphed"],
            "eager_window_ms": times["eager"],
            "graphed_window_ms": times["graphed"],
            "speedup": med["eager"] / med["graphed"],
            "graphed_examples_per_s": cfg.mini_batch_size * 1e3
            / med["graphed"],
            "peak_allocated_gb": {k: v[0] / 2**30 for k, v in peak.items()},
            "allocated_before_gb": allocated_before / 2**30,
            "peak_reserved_gb": {k: v[1] / 2**30 for k, v in peak.items()},
            "capture_s": g_step.capture_s,
            "launches_per_replay": per_replay, "loss": loss,
            "launches": {name: k.launches for name, k in kernels.items()},
            **({"fires": read_fires(state)} if counter else {})}


def lane_grads(model, embed, state, dense, ids, labels, valid, bce):
    """d loss / d gathered rows of every part, as the train step takes
    them (its weights, loss and autograd leaves), from `state`."""
    raws, auxs = embed.gather(state.embed, ids)
    raws = {k: v.detach().requires_grad_() for k, v in raws.items()}
    w = (torch.arange(ids.shape[0], device=ids.device) < valid).float()
    with torch.enable_grad():
        p = model.apply(state.params, dense,
                        embed.transform(state.embed_dense, raws))
        grads = torch.autograd.grad(bce(p, labels, w, w.sum()),
                                    [raws[k] for k in sorted(raws)])
    return dict(zip(sorted(raws), grads)), auxs


def reorder_bound(table, rows, upd):
    """The f32 reordering bound of one scatter-add of `upd` into `table`
    at `rows` (phase_kernels' K2 bound): each of the g_max adds of the
    largest group may round by 2^-24 of its running sum."""
    _, groups = torch.unique(rows.reshape(-1), return_counts=True)
    g_max = int(groups.max())
    return g_max * 2.0 ** -24 * (float(table.abs().max())
                                 + g_max * float(upd.abs().max()))


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _equal_except(a, b, skip):
    """Paths of the tensors of two TrainStates that differ bit for bit,
    those in `skip` left out."""
    out = []

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor) and path not in skip \
                and not torch.equal(_bits(x), _bits(y)):
            out.append(path)
    walk(a._asdict(), b._asdict(), "")
    return out


def cafe_key(embed):
    """(part, its state key) of the layer's CAFE part (a layer whose small
    fields stay full has it after the full table)."""
    i = next(i for i, p in enumerate(embed.parts)
             if type(p).__name__ == "CafePart")
    return embed.parts[i], f"part{i}"


def count_fires(fires, part, sk):
    """Add to `fires` whether the next CAFE+ insert from sketch state `sk`
    resets (real_n past 1.2 x lim) and decays (decay_acc x alpha past V):
    host reads, so eager runs only. Nothing for a v1 part."""
    if not getattr(part, "plus", False):
        return
    cfg = part.sketch_cfg
    fires["reset"] += int(cfg.adjust_threshold
                          and int(sk["real_n"]) > int(cfg.lim * 1.2))
    fires["decay"] += int(float(sk["decay_acc"] * float(np.float32(
        cfg.alpha))) > 10000.0)


def fire_counter(embed):
    """(before_step hook, read) counting on the card how often the next
    CAFE+ insert resets and decays: two compares and one add a step, no
    host read, so the timed windows can carry it."""
    part, key = cafe_key(embed)
    cfg = part.sketch_cfg
    acc = torch.zeros(2, dtype=torch.int32, device=part.device)
    trip, alpha = int(cfg.lim * 1.2), float(np.float32(cfg.alpha))

    def before_step(state):
        sk = state.embed[key]["sketch"]
        acc.add_(torch.stack([sk["real_n"] > trip,
                              sk["decay_acc"] * alpha > 10000.0]))

    def read(state):
        sk = state.embed[key]["sketch"]
        reset, decay = (int(x) for x in acc.cpu())
        return {"reset": reset, "decay": decay, "trip": trip,
                "final": {k: float(sk[k]) for k in ("threshold", "real_n",
                                                     "decay_acc", "step")}}
    return before_step, read


def gate_replay(build_all, build_train_step, clone_state, from_reference,
                to_numpy, bce, cfg, data, batches, exact_tables):
    """Replayed steps against eager ones, with frequency scores (integer
    counts, so no float sum can move the sketch):

    * trajectory: from one start state, the eager and the graphed step
      over the 12 GATE_VALIDS batches (a tail, an empty batch): sketch,
      tick, step, promotions and routed rows bit-equal; with
      `exact_tables` (a deterministic apply) the tables, params and
      metrics too; else their largest differences are recorded;
    * per step: before each of the 12 steps the graphed state is cloned,
      the eager step runs on the clone and the graphed one on the state:
      every tensor and metric bit-equal, the tables bit-equal with
      `exact_tables`, else apart by at most twice the reordering bound of
      the step's scatter-add (reorder_bound: float atomics in index_add_
      and K2 sum in no fixed order, and each order lies within the bound
      of the exact sums)."""
    model, embed, state0, g_step, _ = build_all(cfg, data, device="cuda")
    if not g_step.graphed:
        raise AssertionError("gate: the step is not graphed")
    e_step = build_train_step(model, embed, cfg, capture=False)
    start = clone_state(state0)         # on the card: no host round trip
    del state0

    def batch(i):
        return (*batches[i % len(batches)][:3], GATE_VALIDS[i])

    cafe, key = cafe_key(embed)

    def routed(state):
        _, aux = embed.gather(state.embed, batches[0][1])
        return aux[key][1]

    runs = {}
    fires = {"reset": 0, "decay": 0}
    for name, step in (("eager", e_step), ("graphed", g_step)):
        st, ms = clone_state(start), []
        for i in range(len(GATE_VALIDS)):
            if name == "eager":
                count_fires(fires, cafe, st.embed[key]["sketch"])
            st, m = step(st, *batch(i))
            ms.append({k: v.clone() for k, v in m.items()})
        runs[name] = (st, ms)
    torch.cuda.synchronize()
    (e_st, e_ms), (g_st, g_ms) = runs["eager"], runs["graphed"]
    ints = [f"/embed/{p}/{k}" for p in e_st.embed
            for k in ("tick", "sketch") if k in e_st.embed[p]]
    diff = _equal_except(e_st, g_st, skip=())
    bad_int = [d for d in diff if d == "/step"
               or any(d.startswith(i) for i in ints)]
    promos = [[float(m["cafe_promotions"]) for m in ms]
              for ms in (e_ms, g_ms)]
    if bad_int or promos[0] != promos[1] \
            or not torch.equal(routed(e_st), routed(g_st)):
        raise AssertionError(f"gate trajectory: integer state differs "
                             f"{bad_int}, promotions {promos}")
    if sum(promos[0]) == 0:
        raise AssertionError("gate: no id promoted")
    metric_diff = max(float((em[k] - gm[k]).abs().max())
                      for em, gm in zip(e_ms, g_ms) for k in em)
    if exact_tables and (diff or metric_diff != 0.0):
        raise AssertionError(f"gate trajectory: {diff} differ, metrics by "
                             f"{metric_diff}")
    traj = {"steps": len(GATE_VALIDS), "valids": GATE_VALIDS,
            "integer_state_equal": True, "promotions": promos[1],
            "plus_fires": fires if cafe.plus else None,
            "float_leaves_differing": diff,
            "max_abs_diff_metrics": metric_diff,
            "max_abs_diff_tables": {
                p: float((e_st.embed[p]["table"]
                          - g_st.embed[p]["table"]).abs().max())
                for p in e_st.embed},
            "max_abs_diff_params": max(
                float((a[k] - b[k]).detach().float().abs().max())
                for t in ("bot", "top")
                for a, b in zip(e_st.params[t], g_st.params[t])
                for k in ("w", "b"))}
    del runs, e_st, start

    tables = {p: f"/embed/{p}/table" for p in g_st.embed}
    per_step = []
    eager_twice = []
    for i in range(len(GATE_VALIDS)):
        x = clone_state(g_st)
        # a second eager step from the same state: how far two eager
        # steps' float-atomic sums land apart (0 where none are)
        x2 = None if exact_tables else clone_state(g_st)
        grads, auxs = lane_grads(model, embed, x, *batch(i), bce)
        bounds = {}
        for p, g in grads.items():
            rows = auxs[p][1] if isinstance(auxs[p], tuple) else auxs[p]
            bounds[p] = reorder_bound(x.embed[p]["table"], rows,
                                      cfg.learning_rate * g)
        ex, em = e_step(x, *batch(i))
        if x2 is not None:
            x2, _ = e_step(x2, *batch(i))
            eager_twice.append(max(float(
                (ex.embed[p]["table"] - x2.embed[p]["table"]).abs().max())
                for p in tables))
        g_st, gm = g_step(g_st, *batch(i))
        torch.cuda.synchronize()
        diff = _equal_except(ex, g_st, skip=set(tables.values()))
        bad_m = [k for k in em if not torch.equal(_bits(em[k]),
                                                  _bits(gm[k]))]
        errs = {p: float((ex.embed[p]["table"] - g_st.embed[p]["table"])
                         .abs().max()) for p in tables}
        # each order lies within the bound of the exact sums, so two
        # orders lie within twice it of each other
        bad_t = [p for p, e in errs.items()
                 if e > (0.0 if exact_tables else 2.0 * bounds[p])]
        if diff or bad_m or bad_t:
            raise AssertionError(f"gate step {i}: {diff} and metrics "
                                 f"{bad_m} differ; tables {errs} against "
                                 f"{bounds}")
        per_step.append({"table_max_abs_diff": errs, "bound": bounds})
        del x, x2, ex
    return {"exact_tables": exact_tables, "trajectory": traj,
            "per_step": {"steps": len(per_step),
                         "other_state_and_metrics_equal": True,
                         "eager_vs_eager_table_max_abs_diff": eager_twice,
                         "table_max_abs_diff": max(
                             max(r["table_max_abs_diff"].values())
                             for r in per_step),
                         "largest_share_of_allowed": max(
                             e / (2.0 * r["bound"][p]) if not exact_tables
                             else 0.0 for r in per_step
                             for p, e in r["table_max_abs_diff"].items()),
                         "tightest_bound": min(min(r["bound"].values())
                                               for r in per_step)}}


def phase_eval_graph(build_all, cfg, data, batches, warmup_calls,
                     calls=GRAPH_STEPS, windows=GRAPH_WINDOWS):
    """The eager and the graphed eval step on one trained headline state:
    scores bit-equal batch for batch, then alternating windows of
    `calls` calls (ms a call, median of `windows` each)."""
    model, embed, state, step, g_eval = build_all(cfg, data, device="cuda")
    _, _, _, _, e_eval = build_all(cfg, data, device="cuda", capture=False)
    if not g_eval.graphed or e_eval.graphed:
        raise AssertionError("eval_graph: the eval steps are not "
                             "(graphed, eager)")
    for i in range(4):
        state, _ = step(state, *batches[i])
    for i in range(warmup_calls + len(batches)):
        dense, sparse, _, _ = batches[i % len(batches)]
        got = g_eval(state, dense, sparse).clone()
        want = e_eval(state, dense, sparse)
        if not torch.equal(got, want):
            raise AssertionError(f"eval_graph: scores of batch {i} differ")
    times = {"eager": [], "graphed": []}
    for mode in _order(windows):
        ev = g_eval if mode == "graphed" else e_eval
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            p = ev(state, *batches[i % len(batches)][:2])
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3 / calls)
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    del p
    return {"graphed": True, "scores_equal_batches": warmup_calls
            + len(batches), "calls_per_window": calls, "windows": windows,
            "eager_ms_per_call": med["eager"],
            "graphed_ms_per_call": med["graphed"],
            "eager_window_ms": times["eager"],
            "graphed_window_ms": times["graphed"],
            "speedup": med["eager"] / med["graphed"],
            "capture_s": g_eval.capture_s}


# K3's stages by kernel name: the prep kernel, CUB's radix sort (its
# kernels carry rowsum.cu's wrapped namespace; in this window nothing
# else sorts), the tile kernel and the fix-up kernel
ROWSUM_STAGES = (("prep", "rowsum_prep_kernel"),
                 ("sort", "DeviceRadixSort"),
                 ("sum", "rowsum_tile_kernel"),
                 ("fixup", "rowsum_fixup_kernel"))


def stage_ms(fn, stages, reps=20):
    """Device ms a call of fn() per stage, summed over the kernels whose
    names hold the stage's pattern, from a torch.profiler window of
    `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {f"{name}_ms": 0.0 for name, _ in stages}
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(a, "self_device_time_total",
                    getattr(a, "self_cuda_time_total", 0))
        for name, pattern in stages:
            if pattern in a.key:
                out[f"{name}_ms"] += t / reps / 1e3
    return out


def rowsum_case(rowsum, table, ids, upd, stages=True):
    """K3 against its plain version on one input: a record with its
    times (with `stages`, each stage's from a profiler window). Raises on
    a disagreement."""
    n, d = table.shape
    b = ids.shape[0]
    keep = (ids >= 0) & (ids < n)
    kept = ids[keep].long()
    _, run_sizes = torch.unique(kept, return_counts=True)
    g_max, uniq = int(run_sizes.max()), int(run_sizes.numel())
    before = rowsum.KERNEL.launches
    got = rowsum.sparse_add_dense_(table.clone(), ids, upd)
    if rowsum.KERNEL.launches != before + 1:
        raise AssertionError("K3: the wrapper did not launch the kernel")
    again = rowsum.sparse_add_dense_(table.clone(), ids, upd)
    want = rowsum.sparse_add_dense_plain_(table.clone(), ids, upd)
    err = float((got - want).abs().max())
    # worst-case f32 reordering bound of the longest run (the plain
    # version's index_add_ uses atomics on the card), as for K2
    tol = g_max * 2.0 ** -24 * (float(table.abs().max())
                                + g_max * float(upd.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K3 differs from its plain version: {err} > "
                             f"{tol}")
    if not torch.equal(got, again):
        raise AssertionError("K3: two launches on one input differ")
    # dyadic payloads (multiples of 2^-10, every sum far below 2^14): f32
    # adds them exactly in any order, so K3 must match bit for bit
    table_q = torch.round(table * 1024) / 1024
    upd_q = torch.round(upd * 1024 * 8) / 1024
    got_q = rowsum.sparse_add_dense_(table_q.clone(), ids, upd_q)
    want_q = rowsum.sparse_add_dense_plain_(table_q, ids, upd_q)
    err_exact = float((got_q - want_q).abs().max())
    if err_exact != 0.0:
        raise AssertionError(f"K3 differs from its plain version on exact "
                             f"dyadic sums: {err_exact}")
    del got, again, want, table_q, upd_q, got_q, want_q
    lib_upd = upd[keep].contiguous()
    work = table.clone()
    if stages:
        stages = stage_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd),
                          ROWSUM_STAGES)
        if not all(v > 0 for v in stages.values()):
            raise AssertionError(f"K3: a stage without device time in the "
                                 f"trace: {stages}")
        stages["kernel_ms"] = stages["sum_ms"] + stages["fixup_ms"]
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    return {"shape": [n, d, b], "max_run": g_max, "distinct_rows": uniq,
            "dropped_lanes": int(b - kept.numel()),
            "tiles": -(-b // rowsum.TILE), "sort_bits": n.bit_length(),
            "max_abs_err": err, "tolerance": tol,
            "max_abs_err_dyadic": err_exact, "deterministic": True,
            "ms": time_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd)),
            **(stages or {}),
            "host_ms": host_ms(
                lambda: rowsum.sparse_add_dense_(work, ids, upd)),
            "plain_ms": time_ms(
                lambda: rowsum.sparse_add_dense_plain_(work, ids, upd)),
            "library_ms": time_ms(
                lambda: work.index_add_(0, kept, lib_upd)),
            "bound_ms": bms, "bound_by": by}


def phase_rowsum(rowsum, embed, state, batches):
    """K3 at the headline table: the rows the trained CafePart routes one
    batch to (hot and hashed ids of the 26 fields), Zipf ids drawn as
    the sibling's K2 check draws them (runs of thousands of lanes), and
    one row taking every kept lane, with dropped lanes below 0 and at N
    in the last two."""
    rng = np.random.default_rng(2)
    table = state.embed["part0"]["table"].clone()
    n, d = table.shape
    _, aux = embed.gather(state.embed, batches[0][1])
    routed = aux["part0"][1].reshape(-1).to(torch.int32)
    b = routed.shape[0]
    ranks = (rng.random(b) ** 6 * n).astype(np.int64)
    zipf = ((ranks * 1000000007) % n).astype(np.int32)
    dropped = [rng.choice(b, 24, replace=False) for _ in range(2)]
    zipf[dropped[0]], zipf[dropped[1]] = -1, n
    one_row = np.full(b, n // 3, np.int32)
    one_row[dropped[0]], one_row[dropped[1]] = -1, n
    upd = torch.from_numpy(
        rng.normal(0, 0.01, (b, d)).astype(np.float32)).cuda()
    cases = {"routed": rowsum_case(rowsum, table, routed, upd),
             "zipf": rowsum_case(rowsum, table,
                                 torch.from_numpy(zipf).cuda(), upd),
             "one_row": rowsum_case(rowsum, table,
                                    torch.from_numpy(one_row).cuda(), upd)}
    return cases


def gather_case(gather, table, ids, tile=256):
    """K4 against its plain version on one input, bit for bit, timed as
    phase 2. Raises on a disagreement."""
    b = ids.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    before = gather.KERNEL.launches
    got = gather.gather(table, ids, tile)
    want = gather.gather_plain(table, ids, tile)
    torch.cuda.synchronize()
    if gather.KERNEL.launches != before + 1:
        raise AssertionError("K4: the wrapper did not launch the kernel")
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"K4 differs from its plain version at "
                             f"{tuple(table.shape)} {table.dtype}")
    del got, want
    bms, by = bound_ms(2 * b * row_bytes + b * 4, 0)
    # the copy unit the wrapper picks (its output, a fresh allocation, is
    # 256-byte aligned)
    vec = gather.vector_bytes(row_bytes, table.stride(0)
                              * table.element_size(), table.data_ptr(), 256)
    return {"shape": [*table.shape, b], "dtype": str(table.dtype),
            "tile": tile, "vector_bytes": vec,
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: gather.gather(table, ids, tile)),
            "host_ms": host_ms(lambda: gather.gather(table, ids, tile)),
            "plain_ms": time_ms(lambda: gather.gather_plain(table, ids,
                                                            tile)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, ids)),
            "bound_ms": bms, "bound_by": by}


def phase_gather(gather, embed, state, batches):
    """K4 at decision 4's shape and at the headline table with its routed
    ids (module docstring, phase 13)."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    big = torch.randn((1 << 22, 128), generator=gen, device="cuda")
    uniform = torch.from_numpy(
        rng.integers(0, 1 << 22, 53248).astype(np.int32)).cuda()
    table = state.embed["part0"]["table"]
    _, aux = embed.gather(state.embed, batches[0][1])
    routed = aux["part0"][1].reshape(-1).to(torch.int32)
    n = 1 << 18
    some = torch.from_numpy(rng.integers(0, n, 53248).astype(np.int32)).cuda()
    words = torch.randn((n, 129), generator=gen, device="cuda")[:, 1:]
    halves = torch.randn((n, 65), generator=gen, device="cuda").to(
        torch.bfloat16)[:, 1:]
    cases = {"decision4": gather_case(gather, big, uniform),
             "b_eq_tile": gather_case(gather, big, uniform[:256])}
    del big
    cases.update(
        headline=gather_case(gather, table, routed),
        headline_bf16=gather_case(gather, table.to(torch.bfloat16), routed),
        view_words=gather_case(gather, words, some),
        view_bytes=gather_case(gather, halves, some, tile=128))
    widths = {k: v["vector_bytes"] for k, v in cases.items()}
    if (widths["decision4"], widths["view_words"],
            widths["view_bytes"]) != (16, 4, 1):
        raise AssertionError(f"K4 cases miss a vector width: {widths}")
    torch.cuda.empty_cache()
    return cases


def write_criteo_memmap(make_criteo_arrays, path, rows):
    """A Criteo-Kaggle-shaped dataset in the reference's binary format."""
    a = make_criteo_arrays(rows)
    a.sparse.tofile(os.path.join(path, "processed_sparse_sep.bin"))
    a.dense.tofile(os.path.join(path, "processed_dense.bin"))
    a.label.astype(np.int32).tofile(os.path.join(path,
                                                 "processed_label.bin"))
    a.counts.astype(np.int32).tofile(os.path.join(path,
                                                  "processed_count.bin"))


def run_cli(main_fn, argv, log_name):
    """main_torch.main(argv) with its prints kept in chiprun_out/."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write(buf.getvalue())
    return result, buf.getvalue().splitlines()


def cli_timing(main_fn, eager_fn, make_criteo_arrays, kernels):
    """main_torch.main (graphed) and its eager twin in turns on a
    CLI_TIMING_ROWS memmap (192 train batches): one epoch each at
    --steps_per_dispatch 1 and 8, train ms/it the median of the printed
    32-it windows after it 128 (the driver prints every it up to 100,
    each print a synchronize); then the latency protocol of each (eval
    ms/it). K1 and K3 must launch once a step."""
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_timing_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_TIMING_ROWS)
        base = CLI_FLAGS + ["--data_path", root, "--print_freq", "32"]
        out = {"rows": CLI_TIMING_ROWS}
        for mode, k in (("eager", 1), ("graphed", 1), ("graphed", 8),
                        ("eager", 8)):
            for kern in kernels.values():
                kern.launches = 0
            _, lines = run_cli(main_fn if mode == "graphed" else eager_fn,
                               base + ["--steps_per_dispatch", str(k),
                                       "--test_freq", "0"],
                               f"cli_timing_{mode}_k{k}.txt")
            its = [(int(w[3].split("/")[0]), float(w[7]))
                   for w in (ln.split() for ln in lines
                             if ln.startswith("Finished training it "))]
            windows = [ms for it, ms in its if it > 128 and it % 32 == 0]
            launches = {n: kern.launches for n, kern in kernels.items()}
            if len(windows) != 2 or not (launches["land_max"]
                                         == launches["rowsum"] == 192):
                raise AssertionError(f"cli {mode} k={k}: windows {its}, "
                                     f"launches {launches}")
            out[f"{mode}_k{k}"] = {"train_ms_per_it": float(np.median(
                windows)), "windows_ms": windows, "launches": launches}
        for mode in ("graphed", "eager"):
            tb = os.path.join(root, f"tb_latency_{mode}")
            res, _ = run_cli(main_fn if mode == "graphed" else eager_fn,
                             base + ["--test_throughput", "true",
                                     "--tensor_board_filename", tb],
                             f"cli_latency_{mode}.txt")
            out[f"{mode}_latency"] = res["latency"]
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_cli(main_fn, make_criteo_arrays, kernels, device="cuda", extra=(),
              want=None, tag="cli", quant_bits=()):
    """Runs A (train + eval + checkpoints), B (inference from the best
    checkpoint) and C (latency protocol) of main_torch.main with CLI_FLAGS
    and `extra`, whose steps replay CUDA graphs on the card (train and
    eval). On the card run A must launch `want` (default K1 and K3 48
    times each); the prints go to OUT_DIR/<tag>_run_*.txt. For each of
    `quant_bits`, run B again with --quantize_emb_bits (the result's
    "quant"): its scores held against run B's (score_gate), its accuracy
    within QUANT_GAP of run B's."""
    want = want or {"land_max": 48, "rowsum": 48}
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        base = CLI_FLAGS + ["--data_path", root] + list(extra)
        if device == "cpu":
            base += ["--force_platform", "cpu"]
        model = os.path.join(root, "m")
        tb_a = os.path.join(root, "tb_a")
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res_a, out_a = run_cli(main_fn, base + [
            "--lr_num_warmup_steps", "8", "--lr_decay_start_step", "24",
            "--lr_num_decay_steps", "24", "--print_freq", "8",
            "--test_freq", "24", "--save_model", model, "--save_freq", "20",
            "--tensor_board_filename", tb_a], f"{tag}_run_a.txt")
        wall_a = time.perf_counter() - t0
        launches_a = {name: k.launches for name, k in kernels.items()}
        trained = [ln.split() for ln in out_a
                   if ln.startswith("Finished training it ")]
        its = [int(w[3].split("/")[0]) for w in trained]
        ms_it = [float(w[7]) for w in trained]
        losses = [float(w[-1]) for w in trained]
        evals = [ln for ln in out_a if ln.startswith(" accuracy")]
        if its[-1] != 48 or not all(np.isfinite(losses)):
            raise AssertionError(f"cli run A: its {its}, losses {losses}")
        if len(evals) != 2:
            raise AssertionError(f"cli run A printed {len(evals)} eval "
                                 f"lines, not 2")
        if device == "cuda" and any(launches_a[k] != v
                                    for k, v in want.items()):
            raise AssertionError(f"cli run A: launches {launches_a}, "
                                 f"want {want}")
        for f in ("m", "m.meta.json", "m.latest", "tb_a/scalars.jsonl"):
            if not os.path.exists(os.path.join(root, f)):
                raise AssertionError(f"cli run A wrote no {f}")
        with open(os.path.join(tb_a, "scalars.jsonl")) as f:
            scalars = [json.loads(ln) for ln in f]
        events = {}
        for sc in scalars:
            if sc["tag"] != "Train/Loss":
                events.setdefault(sc["step"], {})[sc["tag"]] = sc["value"]
        best_step = max(events, key=lambda st: (events[st]["Test/Acc"],
                                                -st))
        best = events[best_step]

        res_b, p_b = serve_cli(main_fn, base + [
            "--load_model", model, "--inference_only", "true",
            "--tensor_board_filename", os.path.join(root, "tb_b")],
            f"{tag}_run_b.txt")
        diffs = {k: abs(v - best["Test/Acc" if k == "accuracy" else k])
                 for k, v in res_b["metrics"].items()}
        if not max(diffs.values()) <= 1e-6:
            raise AssertionError(f"cli run B differs from run A's best "
                                 f"test event: {diffs}")
        quant = {}
        for bits in quant_bits:
            res_q, p_q = serve_cli(main_fn, base + [
                "--load_model", model, "--inference_only", "true",
                "--quantize_emb_bits", str(bits),
                "--tensor_board_filename", os.path.join(root, "tb_q")],
                f"{tag}_quant_int{bits}.txt")
            scores = score_gate(f"{tag} int{bits} serving", bits, p_b, p_q)
            gap = abs(res_q["metrics"]["accuracy"]
                      - res_b["metrics"]["accuracy"])
            if not gap < QUANT_GAP:
                raise AssertionError(f"cli int{bits} serving: accuracy "
                                     f"{res_q['metrics']} against float "
                                     f"{res_b['metrics']}")
            quant[f"int{bits}"] = {
                "metrics": res_q["metrics"], "scores_vs_float": scores,
                "accuracy_gap_vs_float": gap,
                "auc_gap_vs_float": abs(res_q["metrics"]["roc_auc"]
                                        - res_b["metrics"]["roc_auc"])}

        tb_c = os.path.join(root, "tb_c")
        for k in kernels.values():
            k.launches = 0
        res_c, _ = run_cli(main_fn, base + [
            "--test_throughput", "true", "--tensor_board_filename", tb_c],
            f"{tag}_run_c.txt")
        launches_c = {name: k.launches for name, k in kernels.items()}
        with open(os.path.join(tb_c, "latency.json")) as f:
            latency = json.load(f)
        if latency != res_c["latency"] or not latency["test"] > 0:
            raise AssertionError(f"cli run C: latency {latency}")
        return {"rows": CLI_ROWS, "run_a": {
                    "its": len(its), "wall_s": wall_a,
                    "ms_per_it_median": float(np.median(ms_it)),
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "eval_lines": evals, "best_event_it": best_step,
                    "best_metrics": best, "launches": launches_a},
                "run_b": {"metrics": res_b["metrics"],
                          "max_abs_diff_vs_run_a_best": max(diffs.values())},
                "run_c": {"latency": latency, "launches": launches_c},
                "quant": {"float_metrics": res_b["metrics"], **quant}}
    finally:
        shutil.rmtree(root, ignore_errors=True)

A2A_IPC = dict(n=4, chunk=13312, dim=16, epochs=3, seed=5,
               graph_replays=3)


def a2a_inputs(n, chunk, dim, seed, rank):
    """Rank `rank`'s seeded all-to-all inputs: ids [n, chunk] int32 and
    rows [n, chunk, dim] f32."""
    rng = np.random.default_rng([seed, rank])
    ids = rng.integers(0, 2**31 - 1, (n, chunk), dtype=np.int64)
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(rng.standard_normal((n, chunk, dim),
                                                 dtype=np.float32)))


def one_owner(rows, rank, n):
    """rows [n * k, D] with every lane l zeroed but on rank l % n."""
    lanes = torch.arange(rows.shape[0]) % n == rank
    return torch.where(lanes[:, None], rows, torch.zeros_like(rows))


def a2a_ipc_rank(rank, store, out_dir):
    """One of the 4 processes of the one-card K5 check: a gloo group for
    the IPC handles, card 0 for the data; writes its verdict as JSON."""
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import Mesh
    cfg = A2A_IPC
    n = cfg["n"]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    mesh = Mesh(size=n, rank=rank, device=torch.device("cuda", 0),
                group=dist.new_group(list(range(n)), backend="gloo"))
    equal = []
    for e in range(cfg["epochs"]):
        seed = cfg["seed"] + e
        ins = [a2a_inputs(n, cfg["chunk"], cfg["dim"], seed, s)
               for s in range(n)]
        for leg in (0, 1):
            got = a2a.all_to_all(ins[rank][leg].cuda(), mesh).cpu()
            want = torch.stack([ins[s][leg][rank] for s in range(n)])
            equal.append(bool(torch.equal(got, want)))
    torch.cuda.synchronize()
    launches = a2a.KERNEL.launches
    # the device all-gather (the ids leg's chunk) and reduce-scatter (the
    # rows leg, each lane non-zero on one rank only, as the exchange's
    # owner answers are) against their plain versions on the gloo group
    # (CPU tensors) and against the seeded inputs
    coll_equal = []
    for e in range(cfg["epochs"]):
        seed = cfg["seed"] + 300 + e
        ins = [a2a_inputs(n, cfg["chunk"], cfg["dim"], seed, s)
               for s in range(n)]
        owned = [one_owner(ins[s][1].reshape(n * cfg["chunk"], cfg["dim"]),
                           s, n) for s in range(n)]
        ids = ins[rank][0][0]
        got = a2a.all_gather(ids.cuda(), mesh).cpu()
        want = torch.cat([ins[s][0][0] for s in range(n)])
        coll_equal.append(bool(torch.equal(got, want) and torch.equal(
            got, a2a.all_gather_plain(ids, mesh))))
        got = a2a.psum_scatter(owned[rank].cuda(), mesh).cpu()
        blk = slice(rank * cfg["chunk"], (rank + 1) * cfg["chunk"])
        want = owned[0][blk].clone()
        for s in range(1, n):
            want += owned[s][blk]
        coll_equal.append(bool(torch.equal(got, want) and torch.equal(
            got, a2a.psum_scatter_plain(owned[rank], mesh))))
    torch.cuda.synchronize()
    coll_launches = a2a.KERNEL.launches - launches
    # the rows leg captured in a CUDA graph on the same workspace: each
    # replay (fresh inputs in the static buffer) is followed by an eager
    # call, and both must deliver their own call's chunks (the call
    # counter lives on the card: a frozen epoch would copy stale slots)
    x = ins[rank][1].cuda()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = a2a.all_to_all(x, mesh)
    graph_equal = []
    for e in range(cfg["graph_replays"]):
        for seed, replay in ((cfg["seed"] + 100 + e, True),
                             (cfg["seed"] + 200 + e, False)):
            ins = [a2a_inputs(n, cfg["chunk"], cfg["dim"], seed, s)
                   for s in range(n)]
            if replay:
                x.copy_(ins[rank][1].cuda())
                graph.replay()
                got = out.cpu()
            else:
                got = a2a.all_to_all(ins[rank][1].cuda(), mesh).cpu()
            want = torch.stack([ins[s][1][rank] for s in range(n)])
            graph_equal.append(bool(torch.equal(got, want)))
    torch.cuda.synchronize()
    del graph
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "equal": equal, "launches": launches,
                   "graph_equal": graph_equal,
                   "collectives_equal": coll_equal,
                   "collective_launches": coll_launches}, f)


def a2a_collectives_n1(a2a, mesh, legs):
    """K5's device all-gather (the ids leg's lanes) and reduce-scatter
    (the rows leg's) at n = 1 against their plain versions: bit-equal,
    ms, plain_ms, the library's NCCL call (all_gather_into_tensor /
    reduce_scatter_tensor) and the bound (each byte read and written
    once)."""
    ids, rows = legs["ids"][0], legs["rows"][0]
    cases = {
        "all_gather": (ids, a2a.all_gather, a2a.all_gather_plain,
                       dist.all_gather_into_tensor),
        "psum_scatter": (rows, a2a.psum_scatter, a2a.psum_scatter_plain,
                         dist.reduce_scatter_tensor)}
    out = {}
    for name, (x, fn, plain, lib) in cases.items():
        got, want = fn(x, mesh), plain(x, mesh)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, x)):
            raise AssertionError(f"K5 {name} differs from its plain "
                                 f"version at n = 1")
        dst = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()
        bms, by = bound_ms(2 * nbytes, 0)
        out[name] = {
            "shape": list(x.shape), "bytes": nbytes, "max_abs_err": 0.0,
            "ms": time_ms(lambda: fn(x, mesh)),
            "plain_ms": time_ms(lambda: plain(x, mesh)),
            "library_ms": time_ms(lambda: lib(dst, x, group=mesh.group)),
            "bound_ms": bms, "bound_by": by}
    return out


def phase_a2a(a2a, mesh):
    """K5 at n = 1 (headline exchange shapes) and across 4 processes on
    the one card: eagerly, then captured in a CUDA graph whose replays
    interleave with eager calls."""
    gen = torch.Generator().manual_seed(4)
    m = 53248
    legs = {"ids": torch.randint(0, 2**31 - 1, (1, m), dtype=torch.int32,
                                 generator=gen).cuda(),
            "rows": torch.randn((1, m, 16), generator=gen).cuda()}
    rec = {"n1": {}}
    for name, x in legs.items():
        got = a2a.all_to_all(x, mesh)
        want = a2a.all_to_all_plain(x, mesh)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, x)):
            raise AssertionError(f"K5 {name} leg differs from its plain "
                                 f"version at n = 1")
        out = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()
        bms, by = bound_ms(2 * nbytes, 0)
        rec["n1"][name] = {
            "shape": list(x.shape), "bytes": nbytes, "max_abs_err": 0.0,
            "ms": time_ms(lambda: a2a.all_to_all(x, mesh)),
            "graph_ms": graph_ms(lambda: a2a.all_to_all(x, mesh)),
            "host_ms": host_ms(lambda: a2a.all_to_all(x, mesh)),
            "plain_ms": time_ms(lambda: a2a.all_to_all_plain(x, mesh)),
            "library_ms": time_ms(lambda: out.copy_(x)),
            "bound_ms": bms, "bound_by": by}
    rec["n1_collectives"] = a2a_collectives_n1(a2a, mesh, legs)

    # 4 processes on card 0, CUDA IPC between them, 3 calls of each leg
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_a2a_",
                            dir=os.path.join(here, "build"))
    ctx = multiprocessing.get_context("spawn")
    n = A2A_IPC["n"]
    procs = [ctx.Process(target=a2a_ipc_rank,
                         args=(r, os.path.join(root, "store"), root))
             for r in range(n)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    verdicts = []
    for r in range(n):
        path = os.path.join(root, f"rank{r}.json")
        if not os.path.exists(path):
            raise AssertionError(f"K5 IPC check: rank {r} wrote no result "
                                 f"(exit codes {[p.exitcode for p in procs]})")
        with open(path) as f:
            verdicts.append(json.load(f))
    shutil.rmtree(root, ignore_errors=True)
    want_launches = 2 * A2A_IPC["epochs"]
    if not all(all(v["equal"]) and v["launches"] == want_launches
               and len(v["graph_equal"]) == 2 * A2A_IPC["graph_replays"]
               and all(v["graph_equal"])
               and len(v["collectives_equal"]) == want_launches
               and all(v["collectives_equal"])
               and v["collective_launches"] == want_launches
               for v in verdicts):
        raise AssertionError(f"K5 across 4 processes on one card: "
                             f"{verdicts}")
    rec["ipc_one_card"] = {
        **A2A_IPC, "bit_equal_every_rank_every_call": True,
        "graph_replays_interleaved_with_eager_bit_equal": True,
        "device_all_gather_and_reduce_scatter_bit_equal_to_plain": True,
        "launches_per_rank": want_launches,
        "collective_launches_per_rank": want_launches,
        "wall_s": time.perf_counter() - t0,
        "timed": False,
        "why_not_timed": "processes sharing one card without MPS run "
                         "time-sliced, not concurrently: a correctness "
                         "check of the IPC writes and flags only"}
    return rec


def phase_sharded_parity(build_all, from_reference, to_numpy, Config, data,
                         batches_cpu, batches_gpu, mesh_gpu, mesh_cpu,
                         plus=False):
    """3 frequency-score steps from one state on the card in each
    exchange mode and on the CPU (gloo, pallas = K5's plain version):
    sketch (v1, or with `plus` CAFE+), routing and promotions equal
    everywhere; tables, params and loss within the bf16-tower bound of
    phase_parity."""
    def cfg(mode):
        return headline_cfg(Config, cafe_use_freq=True,
                            cafe_sketch_threshold=2.0, mesh_shape=1,
                            shard_embeddings=True, shard_exchange=mode,
                            cafe_plus=plus)
    _, _, start, _, _ = build_all(cfg("pallas"), data, mesh=mesh_cpu)
    start = to_numpy(start)          # n = 1: the rank's state is global
    runs = {}
    for name, mesh, batches in (("pallas", mesh_gpu, batches_gpu),
                                ("explicit", mesh_gpu, batches_gpu),
                                ("a2a", mesh_gpu, batches_gpu),
                                ("pallas_cpu", mesh_cpu, batches_cpu)):
        mode = name.split("_")[0]
        _, embed, _, step, _ = build_all(cfg(mode), data, mesh=mesh)
        state = from_reference(start, mesh.device)
        promos = []
        for i in range(3):
            state, m = step(state, *batches[i])
            promos.append(int(m["cafe_promotions"]))
        _, aux = embed.gather(state.embed, batches[0][1])
        runs[name] = (to_numpy(state), float(m["loss"]), promos,
                      aux["part0"][1].cpu())
    ref_state, ref_loss, ref_promos, ref_rows = runs["pallas"]
    rec = {"tolerance": 1e-3, "max_abs_diff": {}, "promotions": ref_promos}
    for name, (st, loss, promos, rows) in runs.items():
        for f in ref_state["embed"]["part0"]["sketch"]:
            if not np.array_equal(st["embed"]["part0"]["sketch"][f],
                                  ref_state["embed"]["part0"]["sketch"][f]):
                raise AssertionError(f"sharded {name}: sketch {f} differs "
                                     f"from the card's pallas run")
        if promos != ref_promos or not torch.equal(rows, ref_rows):
            raise AssertionError(f"sharded {name}: promotions {promos} or "
                                 f"routing differ from the card's pallas "
                                 f"run {ref_promos}")
        diffs = {"loss": abs(loss - ref_loss),
                 "table": float(np.max(np.abs(
                     st["embed"]["part0"]["table"]
                     - ref_state["embed"]["part0"]["table"])))}
        for tower in ("bot", "top"):
            for j, (a, b) in enumerate(zip(st["params"][tower],
                                           ref_state["params"][tower])):
                diffs[f"{tower}{j}"] = float(max(
                    np.max(np.abs(a[k] - b[k])) for k in ("w", "b")))
        rec["max_abs_diff"][name] = diffs
        if not max(diffs.values()) <= rec["tolerance"]:
            raise AssertionError(f"sharded {name} differs from the card's "
                                 f"pallas run: {diffs}")
    if sum(ref_promos) == 0:
        raise AssertionError("sharded parity: no id promoted")
    rec.update(sketch_equal=True, routing_equal=True,
               modes=list(runs))
    return rec


@contextlib.contextmanager
def timed_checkpoints():
    """Host ms of every save and load main_torch's loop makes, by name,
    recorded by wrapping the loop's checkpoint functions (a save ends in
    its barrier, after the file is on disk; a load after the slices are
    on the device)."""
    from cafe_tpu_torch.train import loop
    names = ("save_rolling", "save_checkpoint", "load_checkpoint")
    got = {n: [] for n in names}
    saved = {n: getattr(loop, n) for n in names}

    def timing(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            got[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    for n in names:
        setattr(loop, n, timing(n, saved[n]))
    try:
        yield got
    finally:
        for n in names:
            setattr(loop, n, saved[n])


def _cli_losses(lines):
    """{it: printed loss string} of a main_torch run's train prints."""
    return {int(w[3].split("/")[0]): w[-1] for w in (
        ln.split() for ln in lines if ln.startswith("Finished training it "))}


def phase_cli_sharded(main_fn, make_criteo_arrays, kernels, device="cuda"):
    """main_torch.main on the memmap with the sharded pallas exchange at
    world size 1, checkpointing as one device does: at
    --steps_per_dispatch 1 and 8, run A trains 48 steps with 2 evals of 8
    batches and rolling saves (every 20 its; every 16 at k = 8), run B
    resumes from A's mid-run slot and must print A's losses at every
    iteration both cover; then the latency protocol on the mesh (its
    latency.json); then run A's best checkpoint served through
    --inference_only --load_model on the mesh at f32 and with
    --quantize_emb_bits 8 and 4 (score_gate against the f32 scores,
    accuracy within QUANT_GAP) and on one device without a mesh (the
    1-shard layout, CafePart.enable_sharded_layout) at f32, whose scores
    must equal the mesh's within 1e-6. The steps replay CUDA graphs. K1
    and K3 launch once a train step, K5 4 times a train step and twice
    an eval batch, besides what the warm-up calls launch in their spare
    branches (each kernel's spare_launches: K3 in the full-size apply
    run on clones)."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_clis_",
                            dir=os.path.join(here, "build"))
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        plat = ["--force_platform", "cpu"] if device == "cpu" else []
        one = CLI_FLAGS + plat + ["--data_path", root]
        mesh = one + ["--mesh_shape", "1", "--shard_embeddings", "true",
                      "--shard_exchange", "pallas"]
        out = {}

        def launched(name, lines, steps, eval_calls):
            got = {k: kern.launches for k, kern in kernels.items()}
            spare = {k: kern.spare_launches for k, kern in kernels.items()}
            if eval_calls is None:      # 8 test batches an evaluation
                eval_calls = 8 * sum(ln.startswith(" accuracy")
                                     for ln in lines)
            want = {"land_max": steps, "rowsum": steps,
                    "a2a": 4 * steps + 2 * eval_calls}
            if device == "cuda" and any(got[k] - spare[k] != v
                                        for k, v in want.items()):
                raise AssertionError(f"cli_sharded {name}: launches {got} "
                                     f"({spare} in warm-up spare "
                                     f"branches), expected {want}")
            return got, spare

        def cli(name, argv, steps, eval_calls=None):
            for kern in kernels.values():
                kern.launches = 0
                kern.spare_launches = 0
            t0 = time.perf_counter()
            with timed_checkpoints() as ck_ms:
                res, lines = run_cli(main_fn, argv,
                                     f"cli_sharded_{name}.txt")
            got, spare = launched(name, lines, steps, eval_calls)
            return res, lines, {"wall_s": time.perf_counter() - t0,
                                "checkpoint_ms": {k: v for k, v in
                                                  ck_ms.items() if v},
                                "launches": got,
                                "spare_launches": spare}

        for k, freq in ((1, 20), (8, 16)):
            model = os.path.join(root, f"k{k}", "m")
            base = mesh + ["--steps_per_dispatch", str(k), "--print_freq",
                           "8", "--test_freq", "24", "--save_freq",
                           str(freq)]
            res, lines_a, rec_a = cli(f"k{k}_a", base + [
                "--save_model", model,
                "--tensor_board_filename", os.path.join(root, "tb")], 48)
            losses_a = _cli_losses(lines_a)
            evals = [ln for ln in lines_a if ln.startswith(" accuracy")]
            if max(losses_a) != 48 or len(evals) != 2 or not all(
                    np.isfinite(float(v)) for v in losses_a.values()):
                raise AssertionError(f"cli_sharded k={k} run A: its "
                                     f"{sorted(losses_a)}, {evals}")
            latest = os.path.realpath(model + ".latest")
            other = model + (".rb" if latest.endswith(".ra") else ".ra")
            with open(other + ".meta.json") as f:
                start = json.load(f)["iter"]
            _, lines_b, rec_b = cli(f"k{k}_b", base + [
                "--load_model", other, "--save_model",
                os.path.join(root, f"k{k}", "b"),
                "--tensor_board_filename", ""], 48 - start)
            losses_b = _cli_losses(lines_b)
            common = sorted(set(losses_a) & set(losses_b))
            if not common or common[-1] != 48 or min(losses_b) <= start \
                    or any(losses_a[i] != losses_b[i] for i in common):
                raise AssertionError(
                    f"cli_sharded k={k}: resumed from it {start}: losses "
                    f"{losses_b} against run A's {losses_a}")
            out[f"k{k}"] = {
                "run_a": {**rec_a, "its": max(losses_a),
                          "ms_per_it_median": float(np.median([
                              float(w[7]) for w in (
                                  ln.split() for ln in lines_a
                                  if ln.startswith("Finished"))])),
                          "loss_first": losses_a[min(losses_a)],
                          "loss_last": losses_a[48], "eval_lines": evals,
                          "metrics": res["metrics"]},
                "run_b": {**rec_b, "resumed_from_it": start,
                          "equal_losses_at": common}}
        tb = os.path.join(root, "tb_c")
        # the protocol's 10 warm-up and 1,014 timed eval calls
        res_c, _, rec_c = cli("latency", mesh + [
            "--test_throughput", "true", "--tensor_board_filename", tb], 48,
            eval_calls=1024)
        with open(os.path.join(tb, "latency.json")) as f:
            latency = json.load(f)
        if latency != res_c["latency"] or not latency["test"] > 0:
            raise AssertionError(f"cli_sharded latency: {latency}")
        out["latency"] = {**rec_c, "latency": latency}

        best = os.path.join(root, "k1", "m")
        serve = ["--inference_only", "true", "--load_model", best,
                 "--tensor_board_filename", ""]
        quant, scores = {}, {}
        for bits in (0,) + QUANT_BITS:
            for kern in kernels.values():
                kern.launches = 0
                kern.spare_launches = 0
            t0 = time.perf_counter()
            with timed_checkpoints() as ck_ms:
                res_q, p = serve_cli(main_fn, mesh + serve + [
                    "--quantize_emb_bits", str(bits)],
                    f"cli_sharded_serve_int{bits}.txt")
            name = f"int{bits}" if bits else "f32"
            k5 = kernels["a2a"].launches - kernels["a2a"].spare_launches
            quant[name] = {**res_q["metrics"],
                           "wall_s": time.perf_counter() - t0,
                           "load_ms": ck_ms["load_checkpoint"],
                           "a2a_launches": kernels["a2a"].launches,
                           "a2a_spare_launches":
                               kernels["a2a"].spare_launches}
            # f32 fetches rows through the pallas exchange (ids and rows
            # an eval batch); the quantized lookup's owners dequantize
            # behind an all-gather and a reduce-scatter (no K5)
            want = 0 if bits else 2 * 8
            if device == "cuda" and k5 != want:
                raise AssertionError(f"cli_sharded serve {name}: K5 "
                                     f"launched {k5} (besides spares), "
                                     f"not {want}")
            scores[bits] = p
        t0 = time.perf_counter()
        with timed_checkpoints() as ck_ms:
            res_1, p_1 = serve_cli(main_fn, one + serve,
                                   "cli_sharded_serve_one_device.txt")
        gap_1 = float(np.abs(p_1 - scores[0]).max())
        if not gap_1 <= 1e-6:
            raise AssertionError(f"cli_sharded: one device serves the mesh "
                                 f"checkpoint {gap_1} away from the mesh")
        quant["one_device_f32"] = {**res_1["metrics"],
                                   "wall_s": time.perf_counter() - t0,
                                   "load_ms": ck_ms["load_checkpoint"],
                                   "max_abs_diff_vs_mesh": gap_1}
        gaps = {k: abs(m["accuracy"] - quant["f32"]["accuracy"])
                for k, m in quant.items() if k.startswith("int")}
        if not max(gaps.values()) < QUANT_GAP:
            raise AssertionError(f"cli_sharded serving: {quant}")
        quant["accuracy_gap_vs_f32"] = gaps
        quant["scores_vs_f32"] = {
            f"int{bits}": score_gate(f"cli_sharded int{bits} serving", bits,
                                     scores[0], scores[bits])
            for bits in QUANT_BITS}
        out["serve"] = quant
        out["launches"] = {
            name: sum(r[run]["launches"][name] for r in
                      (out["k1"], out["k8"]) for run in ("run_a", "run_b"))
            + out["latency"]["launches"][name] for name in kernels}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the mesh's steps in CUDA graphs (world size 1, NCCL)
MESH_GRAPH_STEPS, MESH_GRAPH_WINDOWS = 8, 2
MESH_GRAPH_GATE = 3           # replays, each against an eager step
MESH_EVAL_CALLS = 8


def mesh_graph_configs(Config, cfg128):
    """{name: (config, steps a call, K5 launches a step)} of mesh_graph:
    the sharded headline and sibling at world size 1 in each exchange,
    with the unique-compact legs and with a capacity that overflows on
    every step (the full legs in the branch bodies: K5's device
    all-gathers and reduce-scatter, 4 a step), at insert interval 8 (the
    insert's all-gather on K5, 1 in 8 steps), with the dense apply (K3),
    at K = 8, and AdaEmbed at the latency grid's width
    (tools/latency_grid_torch.grid_config). Frequency scores, so that a
    graphed and an eager step from one state keep equal sketches."""
    sh = dict(mesh_shape=1, shard_embeddings=True, cafe_use_freq=True)
    head = headline_cfg(Config, **sh)
    sib = dataclasses.replace(cfg128, **sh)
    r = dataclasses.replace
    return {
        "headline_explicit": (head, 1, 0),
        "headline_pallas": (r(head, shard_exchange="pallas"), 1, 4),
        "headline_a2a": (r(head, shard_exchange="a2a"), 1, 0),
        "headline_unique": (r(head, shard_unique_frac=0.5), 1, 0),
        "headline_unique_overflow": (
            r(head, shard_unique_frac=UNIQUE_FRACS["overflow"]), 1, 4),
        "headline_interval8": (r(head, cafe_insert_interval=8), 1, 0.125),
        "headline_dense": (r(head, sparse_apply_impl="dense"), 1, 0),
        "headline_k8": (head, 8, 0),
        "sibling_explicit": (sib, 1, 0),
        "sibling_pallas": (r(sib, shard_exchange="pallas"), 1, 4),
        "ada_grid": (r(sib, compress_method="ada"), 1, 0),
    }


def _runs_delta(runs0, runs):
    return {c: [a - b for a, b in zip(v, runs0.get(c, [0, 0]))]
            for c, v in runs.items() if v != runs0.get(c, [0, 0])}


def mesh_graph_case(fns, cfg, k, want_a2a, data, batches, mesh, kernels):
    """One configuration of mesh_graph (phase_mesh_graph's docstring).
    Returns (record, model, embed, graphed state)."""
    (build_all, build_train_step, build_multi_step, clone_state, fence,
     branch_runs, warmup_calls) = fns
    gc.collect()
    torch.cuda.empty_cache()
    model, embed, state, e_step, _ = build_all(cfg, data, mesh=mesh,
                                               capture=False)
    g_step = build_train_step(model, embed, cfg, mesh)
    if not g_step.graphed:
        raise AssertionError(f"mesh_graph: not graphed: "
                             f"{g_step.capture_blockers}")
    if k > 1:
        g_step = build_multi_step(g_step, k, donate=True, mesh_size=1)
        e_step = build_multi_step(e_step, k, donate=True, mesh_size=1)
        batches = [tuple(torch.cat([b[j] for b in batches[:k]])
                         for j in range(3)) + (k * batches[0][3],)]
    for kern in kernels.values():
        kern.launches = 0
        kern.spare_launches = 0
    bodies0 = {c: kk.body_launches for c, kk in kernels.items()}
    n = 0

    def run(step, st, count):
        nonlocal n
        for _ in range(count):
            st, m = step(st, *batches[n % len(batches)])
            n += 1
        fence(st, m)
        return st, m

    state, _ = run(g_step, state, warmup_calls + 1)   # warm-ups, capture
    gap = 0.0
    for _ in range(MESH_GRAPH_GATE):
        b = batches[n % len(batches)]
        ex, _ = e_step(clone_state(state), *b)
        state, _ = run(g_step, state, 1)
        gaps, bad = _leaf_gaps(ex, state)
        if bad or max(gaps.values()) > REORDER_TOL:
            raise AssertionError(f"mesh_graph gate: integers {bad}, "
                                 f"floats {gaps}")
        gap = max(gap, max(gaps.values()))
        del ex
    times = {"eager": [], "graphed": []}
    peak = {"eager": 0, "graphed": 0}
    per = {"eager": {}, "graphed": {}}
    runs = {"eager": {}, "graphed": {}}
    for mode in _order(MESH_GRAPH_WINDOWS):
        before = {c: kk.launches for c, kk in kernels.items()}
        runs0 = branch_runs()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = run(e_step if mode == "eager" else g_step, state,
                       MESH_GRAPH_STEPS)
        times[mode].append((time.perf_counter() - t0) * 1e3
                           / MESH_GRAPH_STEPS / k)
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
        for c, kk in kernels.items():
            per[mode][c] = per[mode].get(c, 0) + kk.launches - before[c]
        where = "eager" if mode == "eager" else "graph"
        for c, v in _runs_delta(runs0[where], branch_runs()[where]).items():
            got = runs[mode].setdefault(c, [0, 0])
            runs[mode][c] = [a + b for a, b in zip(got, v)]
    steps = MESH_GRAPH_WINDOWS * MESH_GRAPH_STEPS * k
    per = {mode: {c: v / steps for c, v in d.items() if v}
           for mode, d in per.items()}
    # the true sides' runs: a cond with no else branch (AdaEmbed's
    # decay) has no body to count its untaken runs in a replay
    taken = {mode: {c: v[1] for c, v in r.items() if v[1]}
             for mode, r in runs.items()}
    if per["graphed"] != per["eager"] or taken["graphed"] != \
            taken["eager"] or per["graphed"].get("a2a", 0) != want_a2a:
        raise AssertionError(f"mesh_graph: launches a step {per}, branch "
                             f"runs {runs}, K5 wanted {want_a2a}")
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"mesh_graph: loss {float(m['loss'])}")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    rec = {"k": k, "graphed": True,
           "eager_ms_per_step": med["eager"],
           "graphed_ms_per_step": med["graphed"],
           "speedup": med["eager"] / med["graphed"],
           "eager_window_ms": times["eager"],
           "graphed_window_ms": times["graphed"],
           "launches_per_step": per, "branch_runs": runs,
           "launches_per_replay": g_step.launches_per_replay(),
           "branch_bodies": [(c, side, la) for c, side, la in
                             g_step.branch_launches()],
           "peak_allocated_gb": {c: v / 2**30 for c, v in peak.items()},
           "capture_s": g_step.capture_s, "replays": g_step.replays,
           "host_calls": g_step.host_calls,
           "gate_steps": MESH_GRAPH_GATE, "gate_max_float_gap": gap,
           "integer_state_equal": True,
           "spare_launches": {c: kk.spare_launches
                              for c, kk in kernels.items()
                              if kk.spare_launches},
           "body_launches": {c: kk.body_launches - bodies0[c]
                             for c, kk in kernels.items()
                             if kk.body_launches - bodies0[c]},
           "launches": {c: kk.launches for c, kk in kernels.items()}}
    del e_step, g_step
    return rec, model, embed, state


def mesh_eval_case(g_eval, e_eval, state, batches):
    """A graphed and an eager eval step on one state: scores within 1e-5
    batch for batch over WARMUP + MESH_EVAL_CALLS calls, then windows of
    MESH_EVAL_CALLS calls in turns, ms a call."""
    gap = 0.0
    for i in range(2 + MESH_EVAL_CALLS):
        dense, sparse = batches[i % len(batches)][:2]
        got = g_eval(state, dense, sparse).clone()
        gap = max(gap, float((got - e_eval(state, dense, sparse)).abs()
                             .max()))
    if not gap <= 1e-5 or not g_eval.graphed:
        raise AssertionError(f"mesh_graph eval: scores {gap} apart")
    times = {"eager": [], "graphed": []}
    for mode in _order(MESH_GRAPH_WINDOWS):
        ev = g_eval if mode == "graphed" else e_eval
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_EVAL_CALLS):
            ev(state, *batches[i % len(batches)][:2])
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3
                           / MESH_EVAL_CALLS)
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    return {"max_abs_diff": gap, "eager_ms_per_call": med["eager"],
            "graphed_ms_per_call": med["graphed"],
            "speedup": med["eager"] / med["graphed"],
            "replays": g_eval.replays, "capture_s": g_eval.capture_s}


def phase_mesh_graph(fns, eval_fns, Config, cfg128, data, batches, mesh,
                     kernels):
    """The mesh's steps in CUDA graphs at world size 1 (NCCL), each
    configuration of mesh_graph_configs built once: the graphed train
    step (its 2 warm-up calls and its capture) on the eager step's
    state, then MESH_GRAPH_GATE replays, each against an eager step on a
    clone of the state it started from (integer leaves bit-equal, float
    leaves within REORDER_TOL); then windows of MESH_GRAPH_STEPS steps,
    eager and graphed in turns on that state: ms a step (of the K steps
    a call at K = 8), kernel launches a step and branch runs (equal in
    both modes, the true sides' where a cond has no else branch; K5 4 a
    step in the pallas exchange and with the overflowing compact legs,
    1 in 8 at insert interval 8), the launches inside branch bodies,
    peak memory,
    launches a replay and the branch bodies. On the headline explicit
    state, the graphed eval and int8 eval steps against their eager
    twins (mesh_eval_case)."""
    build_eval_step, build_quantized_eval_step = eval_fns
    out = {}
    for name, (cfg, k, want_a2a) in mesh_graph_configs(Config,
                                                       cfg128).items():
        t0 = time.perf_counter()
        rec, model, embed, state = mesh_graph_case(
            fns, cfg, k, want_a2a, data, batches, mesh, kernels)
        if name == "headline_explicit":
            rec["eval"] = mesh_eval_case(
                build_eval_step(model, embed),
                build_eval_step(model, embed, capture=False), state,
                batches)
            rec["eval_int8"] = mesh_eval_case(
                build_quantized_eval_step(model, embed, state, 8),
                build_quantized_eval_step(model, embed, state, 8,
                                          capture=False), state, batches)
        rec["wall_s"] = time.perf_counter() - t0
        out[name] = rec
        del model, embed, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- QR, Off and AdaEmbed on the mesh, and the unique-compact exchange
SHARDED_MODES = ("explicit", "a2a", "pallas")
SHARDED_GATE_STEPS = 2
SHARDED_WINDOWS, SHARDED_STEPS = 2, 5
# the unique fraction of the compact runs: C = 26,624 lanes of a batch's
# 53,248 hold its ~7-9 thousand distinct rows; C = 5,376 cannot
UNIQUE_FRACS = {"compact": 0.5, "overflow": 0.1}
COMPACT_TOL = 3e-6            # the JAX package's compact-vs-full bound
EXCHANGE_FNS = ("all_gather", "psum", "psum_scatter", "any_rank",
                "_owner_rows", "owner_rows_with", "_local_idx",
                "owner_lookup_1d", "owner_lookup_cyclic", "sharded_fetch",
                "sharded_fetch_a2a", "sharded_apply", "sharded_apply_a2a")


def sharded_method_configs(Config):
    """{name: config} at world size 1: QR (3 operations) and Off at the
    headline flags with the dense apply (K3), AdaEmbed at the sibling's
    (its pool's apply is K2)."""
    mesh = dict(mesh_shape=1, shard_embeddings=True)
    dense = dict(sparse_apply_impl="dense", **mesh)
    return {
        "qr_add": headline_cfg(Config, compress_method="qr", **dense),
        "qr_mult": headline_cfg(Config, compress_method="qr",
                                qr_operation="mult", **dense),
        "qr_concat": headline_cfg(Config, compress_method="qr",
                                  qr_operation="concat", **dense),
        "off": headline_cfg(Config, compress_method="off", **dense),
        "ada_sibling": headline_cfg(Config, compress_method="ada",
                                    dataset="criteotb", embedding_dim=128,
                                    compress_rate=0.1, learning_rate=1.0,
                                    **mesh)}


def predicted_a2a(embed):
    """K5 launches one pallas train step makes: an ids and a rows leg for
    each row fetch and each row apply through the exchange (Off's forward
    and AdaEmbed's whole step are owner-compute, as in the JAX package)."""
    legs = {"OffPart": 2, "AdaPart": 0}
    return sum(legs.get(type(p).__name__, 4) for p in embed.parts
               if p.mesh is not None and p.exchange_mode == "pallas")


@contextlib.contextmanager
def exchange_timer():
    """CUDA events around every outermost call of parallel/exchange.py's
    functions (EXCHANGE_FNS) from the port's modules, less the optimizer
    apply (ops/sparse.apply_rows) nested in them. Yields a list of
    (start, end, sign) to read after a synchronize (exchange_ms)."""
    from cafe_tpu_torch.parallel import exchange
    marks, depth = [], [0]

    def wrap(fn, sign):
        def wrapped(*args, **kwargs):
            outer = depth[0] == 0 if sign > 0 else depth[0] == 1
            depth[0] += sign > 0
            if outer:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= sign > 0
                if outer:
                    ev[1].record()
                    marks.append(ev + (sign,))
        return wrapped

    fns = {n: getattr(exchange, n) for n in EXCHANGE_FNS}
    patched = [(exchange, "apply_rows", exchange.apply_rows)]
    exchange.apply_rows = wrap(exchange.apply_rows, -1)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("cafe_tpu_torch"):
            for name, fn in fns.items():
                if getattr(mod, name, None) is fn:
                    patched.append((mod, name, fn))
                    setattr(mod, name, wrap(fn, 1))
    try:
        yield marks
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def exchange_ms(marks) -> float:
    return sum(sign * a.elapsed_time(b) for a, b, sign in marks)


def timed_steps(step, state, batches, fence, windows, steps, start=0):
    """`windows` windows of `steps` eager steps, each ended by a fence,
    then one more window inside exchange_timer. Returns (state, ms/step
    of each window, exchange ms/step and ms/step of the timed window)."""
    win, n = [], start
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        win.append((time.perf_counter() - t0) * 1e3 / steps)
    with exchange_timer() as marks:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        ms = (time.perf_counter() - t0) * 1e3 / steps
    return state, win, exchange_ms(marks) / steps, ms


def _int_aux(embed, state, ids):
    """The integer tensors of the layer's aux for `ids` (routing), as
    numpy, keyed by part and position."""
    _, aux = embed.gather(state.embed, ids)
    out = {}
    for k, v in aux.items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            if not t.is_floating_point():
                out[f"{k}[{i}]"] = t.cpu().numpy()
    return out


def _np_leaves(tree, path=""):
    """(path, numpy array) of every leaf of nested dicts / lists of numpy
    arrays (to_numpy's trees), dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _np_leaves(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, np.asarray(tree))]


def _held(name, got, ref, tol, rel=False):
    """Integer leaves equal, float leaves within `tol` (with `rel`, within
    tol * (1 + |reference|)); returns the largest float gap by path
    (relative to 1 + |reference| with `rel`)."""
    gaps = {}
    got, ref = _np_leaves(got), _np_leaves(ref)
    if [p for p, _ in got] != [p for p, _ in ref]:
        raise AssertionError(f"{name}: another structure")
    for (path, a), (_, b) in zip(got, ref):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {path} shape {a.shape}")
        if a.dtype.kind in "biu":
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: {path} differs")
            continue
        d = np.abs(a - b) / (1 + np.abs(b)) if rel else np.abs(a - b)
        gaps[path] = float(d.max()) if d.size else 0.0
        if not gaps[path] <= tol:
            raise AssertionError(f"{name}: {path} differs by {gaps[path]}"
                                 f"{' relative' if rel else ''}")
    return gaps


def sharded_method_run(build_all, from_reference, to_numpy, cfg, data,
                       batches, mesh, starts, fence, kernels):
    """SHARDED_GATE_STEPS steps of `cfg` on `mesh`, step i from the global
    state starts[i] (numpy), or, given one state, the trajectory from it;
    then a warm-up step and timed_steps. Returns (the states after each
    gate step as numpy, per-step metrics, the routing of batch 0 after
    each, record). A reference's trajectory gives the others their
    starts: each compared step then begins from one state, as card_vs_cpu
    and the replay gate compare, since float atomics (index_add_, K2)
    round apart by run and the bf16 towers can carry a one-ulp gap of one
    step into the next steps' gradients."""
    _, embed, own, step, _ = build_all(cfg, data, mesh=mesh,
                                       capture=False)
    del own
    trajectory = isinstance(starts, dict)
    state = from_reference(starts, mesh.device) if trajectory else None
    metrics, routing, gated = [], [], []
    for i in range(SHARDED_GATE_STEPS):
        if not trajectory:
            state = from_reference(starts[i], mesh.device)
        state, m = step(state, *batches[i % len(batches)])
        metrics.append({k: float(v) for k, v in m.items()})
        routing.append(_int_aux(embed, state, batches[0][1]))
        gated.append(to_numpy(state))
    for k in kernels.values():
        k.launches = 0
    state, m = step(state, *batches[0])
    fence(state, m)
    state, win, ex_ms, ex_win = timed_steps(
        step, state, batches, fence, SHARDED_WINDOWS, SHARDED_STEPS, 1)
    steps = 1 + (SHARDED_WINDOWS + 1) * SHARDED_STEPS
    launches = {name: k.launches for name, k in kernels.items()}
    want = {name: v * steps for name, v in predicted_launches(
        embed, state, cfg.mini_batch_size).items()}
    want["a2a"] = predicted_a2a(embed) * steps
    if mesh.device.type == "cuda" and any(
            launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{cfg.compress_method} {cfg.shard_exchange}: "
                             f"launches {launches}, predicted {want}")
    ms = float(np.median(win))
    rec = {"parts": [(type(p).__name__, p.mesh is not None)
                     for p in embed.parts],
           "ms_per_step": ms, "window_ms": win, "steps": steps,
           "examples_per_s": cfg.mini_batch_size * 1e3 / ms,
           "exchange_ms_per_step": ex_ms, "exchange_window_ms": ex_win,
           "exchange_share": ex_ms / ex_win, "launches": launches,
           "a2a_per_step": predicted_a2a(embed)}
    del state, embed, step
    torch.cuda.empty_cache()
    return gated, metrics, routing, rec


def phase_sharded_methods(build_all, from_reference, to_numpy, bce, Config,
                          data, batches, batches_cpu, mesh_gpu, mesh_cpu,
                          fence, kernels):
    """QR (add, mult, concat) and Off at the headline flags (dense apply)
    and AdaEmbed at the sibling's, sharded at world size 1. On the card
    in the explicit, a2a and pallas modes, SHARDED_GATE_STEPS steps, each
    from the pallas run's state before it (sharded_method_run): integer
    state (Off's hot_dict, AdaEmbed's dic and step), the routing and
    AdaEmbed's admitted counts equal to the pallas run's step; tables,
    loss and dense params within DENSE_TOL of it (AdaEmbed's importance
    within DENSE_TOL relative). The pallas mode against the
    CPU's (gloo, K5's plain version): gate_card_cpu on the two meshes,
    phase 23's gate (integer state and routing exact, each scatter-added
    table and AdaEmbed's importance within its lanes' card-vs-CPU gap
    plus twice the reordering bound, dense params within DENSE_TOL).
    Then eager ms/step (SHARDED_WINDOWS windows of SHARDED_STEPS), the
    exchange's device time a step and its share, and the launches: K2 /
    K3 by the apply routes, K5 by predicted_a2a."""
    out = {}
    for name, base in sharded_method_configs(Config).items():
        t0 = time.perf_counter()

        def cfg(mode):
            return dataclasses.replace(base, shard_exchange=mode)

        _, _, start, _, _ = build_all(cfg("pallas"), data, mesh=mesh_cpu,
                                      capture=False)
        start = to_numpy(start)          # n = 1: the rank's state is global
        runs = {"pallas": sharded_method_run(
            build_all, from_reference, to_numpy, cfg("pallas"), data,
            batches, mesh_gpu, start, fence, kernels)}
        starts = [start] + runs["pallas"][0][:-1]
        for mode in (m for m in SHARDED_MODES if m != "pallas"):
            runs[mode] = sharded_method_run(
                build_all, from_reference, to_numpy, cfg(mode), data,
                batches, mesh_gpu, starts, fence, kernels)
        ref_states, ref_metrics, ref_routing, _ = runs["pallas"]
        rec = {"dim": base.embedding_dim, "compress_rate":
               base.compress_rate, "tolerance": DENSE_TOL,
               "max_abs_diff": {}, "modes": {}}
        for mode, (states, metrics, routing, r) in runs.items():
            gaps = {}
            for i, (a, b) in enumerate(zip(metrics, ref_metrics)):
                where = f"sharded_methods {name} {mode} step {i}"
                if a.get("ada_admitted") != b.get("ada_admitted") or \
                        not abs(a["loss"] - b["loss"]) <= DENSE_TOL:
                    raise AssertionError(f"{where}: {a} against the "
                                         f"card's pallas run {b}")
                _held(where, routing[i], ref_routing[i], 0)
                st, ref_state = states[i], ref_states[i]
                for key, part in st["embed"].items():
                    for leaf, v in part.items():
                        got = _held(
                            where, {f"{key}/{leaf}": v},
                            {f"{key}/{leaf}": ref_state["embed"][key][leaf]},
                            DENSE_TOL, rel=leaf == "grad_norm")
                        for path, gap in got.items():
                            gaps[path] = max(gaps.get(path, 0.0), gap)
                for path, gap in _held(where, st["params"],
                                       ref_state["params"],
                                       DENSE_TOL).items():
                    gaps[path] = max(gaps.get(path, 0.0), gap)
            rec["max_abs_diff"][mode] = {
                "loss": max(abs(a["loss"] - b["loss"])
                            for a, b in zip(metrics, ref_metrics)),
                **{k: v for k, v in gaps.items() if v}}
            rec["modes"][mode] = r
        rec["metrics"] = ref_metrics
        rec["card_vs_cpu"] = gate_card_cpu(
            build_all, from_reference, to_numpy, bce, cfg("pallas"), data,
            batches, batches_cpu, meshes=(mesh_gpu, mesh_cpu))
        rec.update(integer_state_equal=True, routing_equal=True,
                   wall_s=time.perf_counter() - t0)
        out[name] = rec
    return out


def phase_unique_compact(build_all, from_reference, to_numpy, Config, data,
                         batches, mesh, fence, methods=("hash", "cafe")):
    """hash and CAFE v1 (frequency scores, threshold 2) at the headline
    flags under the explicit exchange at world size 1, with
    shard_unique_frac 0.5 (the compact branch) and 0.1 (it overflows: the
    full-size branch), each against the full-size run (frac 0) from one
    state: loss within 1e-5 relative, tables within COMPACT_TOL, every
    integer leaf (the sketch) equal; the branch each leg of each step
    took; eager ms/step of each."""
    from cafe_tpu_torch.parallel import exchange
    out = {}
    for method in methods:
        base = headline_cfg(Config, compress_method=method, mesh_shape=1,
                            shard_embeddings=True, cafe_use_freq=True,
                            cafe_sketch_threshold=2.0)
        _, _, start, _, _ = build_all(base, data, mesh=mesh, capture=False)
        start = to_numpy(start)
        runs = {}
        for tag, frac in (("full", 0.0), *UNIQUE_FRACS.items()):
            cfg = dataclasses.replace(base, shard_unique_frac=frac)
            _, embed, _, step, _ = build_all(cfg, data, mesh=mesh,
                                             capture=False)
            state = from_reference(start, mesh.device)
            losses, branches = [], []
            for i in range(SHARDED_GATE_STEPS):
                since = exchange.exchange_branches()
                state, m = step(state, *batches[i])
                losses.append(float(m["loss"]))
                branches.append(exchange.exchange_branches(since))
            gated = to_numpy(state.embed)
            state, win, ex_ms, ex_win = timed_steps(
                step, state, batches, fence, SHARDED_WINDOWS,
                SHARDED_STEPS, SHARDED_GATE_STEPS)
            ms = float(np.median(win))
            runs[tag] = (gated, losses, {
                "unique_frac": frac, "branches_by_step": branches,
                "ms_per_step": ms, "window_ms": win,
                "exchange_ms_per_step": ex_ms,
                "exchange_share": ex_ms / ex_win})
            del state, embed, step
        ref, ref_losses, _ = runs["full"]
        rec = {}
        for tag, (gated, losses, r) in runs.items():
            want = {"full": [{}] * SHARDED_GATE_STEPS,
                    "compact": [{"fetch_compact": 1, "apply_compact": 1}]
                    * SHARDED_GATE_STEPS,
                    "overflow": [{"fetch_full": 1, "apply_full": 1}]
                    * SHARDED_GATE_STEPS}[tag]
            if r["branches_by_step"] != want:
                raise AssertionError(f"unique_compact {method} {tag}: "
                                     f"branches {r['branches_by_step']}")
            if not np.allclose(losses, ref_losses, rtol=1e-5, atol=0):
                raise AssertionError(f"unique_compact {method} {tag}: "
                                     f"losses {losses} against {ref_losses}")
            r["max_abs_diff_vs_full"] = _held(
                f"unique_compact {method} {tag}", gated, ref, COMPACT_TOL)
            r["losses"] = losses
            rec[tag] = r
        out[method] = rec
    return out


# the mesh CLI runs: (name, flags after CLI_FLAGS, launches a train step,
# launches an f32 eval batch)
CLI_MESH = {
    # QR on the mesh (dense apply: K3 for q and r), the pallas legs (K5:
    # ids and rows of the q fetch and apply, ids and rows of an eval)
    "sharded_methods_cli_qr": (
        ["--compress_method", "qr", "--shard_exchange", "pallas"],
        {"rowsum": 2, "a2a": 4}, {"a2a": 2}),
    # CAFE v1 under auto: the one-device insert (K1) and dense apply (K3)
    "cli_auto": (["--shard_exchange", "auto"],
                 {"land_max": 1, "rowsum": 1}, {}),
    # CAFE v1 on the (1, 1) two-level mesh: its hierarchical legs
    "cli_two_level": (["--mesh_inner", "1"],
                      {"land_max": 1, "rowsum": 1}, {}),
}


def phase_cli_mesh(main_fn, make_criteo_arrays, kernels, name,
                   device="cuda"):
    """main_torch.main with CLI_MESH[name]'s flags, --mesh_shape 1
    --shard_embeddings true on the CLI_ROWS memmap (dense apply): run A
    trains 48 steps with 2 evals and rolling saves every 20 its, run B
    resumes from A's mid-run slot and must print A's losses where both
    print; then A's best checkpoint served on the mesh at f32 and int8
    (score_gate, accuracy within QUANT_GAP). The kernels launch as
    CLI_MESH[name] says a train step and an f32 eval batch (the quantized
    lookup's owners dequantize behind an all-gather and a reduce-scatter:
    no K5), besides what the graphed steps' warm-up calls launch in their
    spare branches (kernels' spare_launches)."""
    flags, per_step, per_eval = CLI_MESH[name]
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_",
                            dir=os.path.join(here, "build"))
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        plat = ["--force_platform", "cpu"] if device == "cpu" else []
        mesh = CLI_FLAGS + plat + flags + [
            "--data_path", root, "--mesh_shape", "1",
            "--shard_embeddings", "true",
            "--print_freq", "8", "--test_freq", "24", "--save_freq", "20"]
        model = os.path.join(root, "m")
        out, total = {}, {n: 0 for n in kernels}

        def counted():
            got = {n: k.launches for n, k in kernels.items()}
            spare = {n: k.spare_launches for n, k in kernels.items()}
            for n, v in got.items():
                total[n] += v
            return got, spare, {n: got[n] - spare[n] for n in got}

        def cli(tag, argv, steps, evals):
            for k in kernels.values():
                k.launches = 0
                k.spare_launches = 0
            t0 = time.perf_counter()
            res, lines = run_cli(main_fn, argv, f"{name}_{tag}.txt")
            got, spare, main = counted()
            want = {n: per_step.get(n, 0) * steps
                    + per_eval.get(n, 0) * 8 * evals for n in kernels}
            if device == "cuda" and main != want:
                raise AssertionError(f"{name} {tag}: launches {got} "
                                     f"({spare} in warm-up spare "
                                     f"branches), expected {want}")
            return res, lines, {"wall_s": time.perf_counter() - t0,
                                "launches": got, "spare_launches": spare}

        _, lines_a, rec_a = cli("a", mesh + ["--save_model", model,
                                             "--tensor_board_filename", ""],
                                48, 2)
        losses_a = _cli_losses(lines_a)
        evals = [ln for ln in lines_a if ln.startswith(" accuracy")]
        if max(losses_a) != 48 or len(evals) != 2 or not all(
                np.isfinite(float(v)) for v in losses_a.values()):
            raise AssertionError(f"{name} run A: its "
                                 f"{sorted(losses_a)}, {evals}")
        latest = os.path.realpath(model + ".latest")
        other = model + (".rb" if latest.endswith(".ra") else ".ra")
        with open(other + ".meta.json") as f:
            start = json.load(f)["iter"]
        _, lines_b, rec_b = cli("b", mesh + [
            "--load_model", other, "--save_model",
            os.path.join(root, "b"), "--tensor_board_filename", ""],
            48 - start, 1 + (start < 24))
        losses_b = _cli_losses(lines_b)
        common = sorted(set(losses_a) & set(losses_b))
        if not common or common[-1] != 48 or any(
                losses_a[i] != losses_b[i] for i in common):
            raise AssertionError(f"{name}: resumed from it {start}: "
                                 f"losses {losses_b} against {losses_a}")
        out["run_a"] = {**rec_a, "eval_lines": evals,
                        "loss_first": losses_a[min(losses_a)],
                        "loss_last": losses_a[48]}
        out["run_b"] = {**rec_b, "resumed_from_it": start,
                        "equal_losses_at": common}
        serve, scores = {}, {}
        for bits in (0, 8):
            for k in kernels.values():
                k.launches = 0
                k.spare_launches = 0
            res, scores[bits] = serve_cli(main_fn, mesh + [
                "--inference_only", "true", "--load_model", model,
                "--quantize_emb_bits", str(bits),
                "--tensor_board_filename", ""],
                f"{name}_serve_int{bits}.txt")
            got, spare, main = counted()
            want = {n: 0 if bits else per_eval.get(n, 0) * 8
                    for n in kernels}
            if device == "cuda" and main != want:
                raise AssertionError(f"{name} serve int{bits}: launches "
                                     f"{got} ({spare} in warm-up spare "
                                     f"branches), expected {want}")
            serve[f"int{bits}" if bits else "f32"] = res["metrics"]
        gap = abs(serve["int8"]["accuracy"] - serve["f32"]["accuracy"])
        if not gap < QUANT_GAP:
            raise AssertionError(f"{name} serving: {serve}")
        serve["int8_vs_f32"] = score_gate(f"{name} int8 serving", 8,
                                          scores[0], scores[8])
        out["serve"] = serve
        out["launches"] = total
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the rest of the mesh: --shard_exchange auto, the two-level mesh,
# the wire audit (world size 1 on the card)

def auto_configs(Config, cfg128):
    """{name: config} of sharded_auto: the headline (index_add_ apply),
    its dense apply (K3) and the sibling (K2), each under auto."""
    auto = dict(mesh_shape=1, shard_embeddings=True, shard_exchange="auto")
    return {"headline": headline_cfg(Config, **auto),
            "headline_dense": headline_cfg(Config, sparse_apply_impl="dense",
                                           **auto),
            "sibling": dataclasses.replace(cfg128, **auto)}


def gate_auto_single(build_all, from_reference, to_numpy, bce, cfg, data,
                     batches, mesh):
    """SHARDED_GATE_STEPS steps of `cfg` under auto on `mesh` and on one
    card without a mesh, each step from one state (the one-card
    trajectory's): every integer leaf (the sketch's val / cnt's bits
    aside, dic, free, free_top; the tick), the promotions and the routed
    rows exactly equal; the sketch's counts and every other float leaf of
    the embedding state bit-equal, except each scatter-added table, which
    must stay within twice the f32 reordering bound of its step's
    scatter-add (both sides sum duplicate rows in float atomics); dense
    params and the loss within DENSE_TOL."""
    one = dataclasses.replace(cfg, mesh_shape=None, shard_embeddings=False,
                              shard_exchange="explicit")
    o_model, o_embed, o_state, o_step, _ = build_all(one, data,
                                                     device="cuda",
                                                     capture=False)
    _, a_embed, _, a_step, _ = build_all(cfg, data, mesh=mesh,
                                         capture=False)
    lr = cfg.learning_rate
    rec = {"steps": SHARDED_GATE_STEPS, "max_abs_diff": {},
           "max_share_of_bound": {}, "promotions": []}

    def worse(d, key, v):
        d[key] = max(d.get(key, 0.0), v)

    for i in range(SHARDED_GATE_STEPS):
        b = batches[i]
        a_state = from_reference(to_numpy(o_state), mesh.device)
        grads, aux = lane_grads(o_model, o_embed, o_state, *b, bce)
        bounds = {}
        for j, part in enumerate(o_embed.parts):
            key = f"part{j}"
            for leaf, rows, upd in sparse_updates(
                    part, o_state.embed[key], b[1][:, o_embed._cols[j]],
                    grads[key], aux[key], lr):
                table = o_state.embed[key][leaf]
                keep = (rows >= 0) & (rows < table.shape[0])
                bounds[f"/{key}/{leaf}"] = 2 * reorder_bound(
                    table, rows[keep], upd)
        o_state, om = o_step(o_state, *b)
        a_state, am = a_step(a_state, *b)
        if int(om["cafe_promotions"]) != int(am["cafe_promotions"]):
            raise AssertionError(f"auto step {i}: promotions "
                                 f"{int(am['cafe_promotions'])} against "
                                 f"one card's {int(om['cafe_promotions'])}")
        rec["promotions"].append(int(am["cafe_promotions"]))
        worse(rec["max_abs_diff"], "loss",
              abs(float(om["loss"]) - float(am["loss"])))
        got, ref = to_numpy(a_state), to_numpy(o_state)
        for path, a in _np_leaves(got["embed"]):
            r = dict(_np_leaves(ref["embed"]))[path]
            if path in bounds:
                diff = float(np.abs(a - r).max())
                worse(rec["max_abs_diff"], path, diff)
                worse(rec["max_share_of_bound"], path,
                      diff / bounds[path] if bounds[path] else 0.0)
                if not diff <= bounds[path]:
                    raise AssertionError(f"auto step {i}: {path} differs "
                                         f"by {diff} > {bounds[path]}")
            elif not np.array_equal(a, r):
                raise AssertionError(f"auto step {i}: {path} differs from "
                                     f"one card's")
        gaps = _held(f"auto step {i}", got["params"], ref["params"],
                     DENSE_TOL)
        worse(rec["max_abs_diff"], "params", max(gaps.values()))
        _held(f"auto step {i} routing", _int_aux(a_embed, a_state, b[1]),
              _int_aux(o_embed, o_state, b[1]), 0)
    if sum(rec["promotions"]) == 0:
        raise AssertionError("auto gate: no id promoted")
    rec.update(integer_state_equal=True, routing_equal=True,
               dense_tolerance=DENSE_TOL)
    return rec


def layout_bytes(embed, state):
    """The auto layout's bytes by part at world size 1: the sharded
    tables (their global bytes) and what every rank holds whole (the
    sketch, small tables, the tick)."""
    from cafe_tpu_torch.utils.timing import tensors_of
    out = {}
    for i, p in enumerate(embed.parts):
        st = state.embed[f"part{i}"]
        sharded = sum(t.numel() * t.element_size() for k, t in st.items()
                      if k in p.auto_keys)
        whole = sum(t.numel() * t.element_size()
                    for t in tensors_of(st)) - sharded
        out[f"part{i}:{type(p).__name__}"] = {
            "sharded_bytes": sharded, "whole_bytes": whole,
            "whole_over_sharded": whole / sharded if sharded else None}
    return out


def phase_sharded_auto(build_all, from_reference, to_numpy, bce, Config,
                       cfg128, data, batches, batches_cpu, mesh_gpu,
                       mesh_cpu, fence, kernels):
    """--shard_exchange auto at world size 1 (NCCL) for auto_configs: the
    gate against one card's single-device step (gate_auto_single, with
    frequency scores and threshold 2 so ids promote), the headline's
    card_vs_cpu (phase 23's gate on the two meshes of one rank), then
    eager ms/step (SHARDED_WINDOWS windows of SHARDED_STEPS) with the
    exchange's device time, the launches a step (K1 once; K3 once in
    dense; K2 once at the sibling) and the layout's bytes."""
    out = {}
    for name, cfg in auto_configs(Config, cfg128).items():
        t0 = time.perf_counter()
        gate = dataclasses.replace(cfg, cafe_use_freq=True,
                                   cafe_sketch_threshold=2.0)
        rec = {"vs_one_card": gate_auto_single(
            build_all, from_reference, to_numpy, bce, gate, data, batches,
            mesh_gpu)}
        torch.cuda.empty_cache()
        if name == "headline":
            rec["card_vs_cpu"] = gate_card_cpu(
                build_all, from_reference, to_numpy, bce, gate, data,
                batches, batches_cpu, meshes=(mesh_gpu, mesh_cpu))
        _, embed, state, step, _ = build_all(cfg, data, mesh=mesh_gpu,
                                             capture=False)
        rec["layout"] = embed.auto_layout()
        rec["bytes"] = layout_bytes(embed, state)
        for k in kernels.values():
            k.launches = 0
        state, m = step(state, *batches[0])
        fence(state, m)
        state, win, ex_ms, ex_win = timed_steps(
            step, state, batches, fence, SHARDED_WINDOWS, SHARDED_STEPS, 1)
        steps = 1 + (SHARDED_WINDOWS + 1) * SHARDED_STEPS
        launches = {n: k.launches for n, k in kernels.items()}
        want = {n: v * steps for n, v in predicted_launches(
            embed, state, cfg.mini_batch_size).items()}
        want["a2a"] = 0
        if mesh_gpu.device.type == "cuda" and any(
                launches[k] != v for k, v in want.items()):
            raise AssertionError(f"sharded_auto {name}: launches "
                                 f"{launches}, predicted {want}")
        ms = float(np.median(win))
        rec.update(ms_per_step=ms, window_ms=win, steps=steps,
                   examples_per_s=cfg.mini_batch_size * 1e3 / ms,
                   exchange_ms_per_step=ex_ms, exchange_window_ms=ex_win,
                   exchange_share=ex_ms / ex_win, launches=launches,
                   loss=float(m["loss"]), wall_s=time.perf_counter() - t0)
        if not np.isfinite(rec["loss"]):
            raise AssertionError(f"sharded_auto {name}: loss {rec['loss']}")
        del state, embed, step
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def phase_sharded_two_level(build_all, from_reference, to_numpy, Config,
                            data, batches, mesh_flat, mesh_two, fence,
                            kernels):
    """The (1, 1) two-level mesh (--mesh_inner 1; its hierarchical legs
    run on groups of one): CAFE v1 at the headline flags (frequency
    scores, threshold 2) on it and on the flat mesh, SHARDED_GATE_STEPS
    steps, each from the flat run's state (sharded_method_run):
    promotions, the sketch and every integer leaf exactly equal, tables
    and params within DENSE_TOL; eager
    ms/step and the exchange's device share; K1 once a step. Then hash
    with --shard_unique_frac 0.5 (compact) and 0.1 (full-size) against
    the full-size run on it (phase_unique_compact's gates)."""
    cfg = headline_cfg(Config, mesh_shape=1, shard_embeddings=True,
                       mesh_inner=1, cafe_use_freq=True,
                       cafe_sketch_threshold=2.0)
    _, _, start, _, _ = build_all(cfg, data, mesh=mesh_flat, capture=False)
    start = to_numpy(start)
    flat = sharded_method_run(build_all, from_reference, to_numpy, cfg, data,
                              batches, mesh_flat, start, fence, kernels)
    ref_states, ref_metrics, ref_routing, flat_rec = flat
    states, metrics, routing, rec = sharded_method_run(
        build_all, from_reference, to_numpy, cfg, data, batches, mesh_two,
        [start] + ref_states[:-1], fence, kernels)
    gaps = {}
    for i, (a, b) in enumerate(zip(metrics, ref_metrics)):
        if a["cafe_promotions"] != b["cafe_promotions"] or \
                not abs(a["loss"] - b["loss"]) <= DENSE_TOL:
            raise AssertionError(f"two_level step {i}: {a} against the "
                                 f"flat mesh's {b}")
        _held(f"two_level routing step {i}", routing[i], ref_routing[i], 0)
        for path, gap in _held(f"two_level step {i}", states[i],
                               ref_states[i], DENSE_TOL).items():
            gaps[path] = max(gaps.get(path, 0.0), gap)
    if sum(m["cafe_promotions"] for m in metrics) == 0:
        raise AssertionError("two_level: no id promoted")
    if mesh_two.device.type == "cuda" and \
            rec["launches"]["land_max"] != rec["steps"]:
        raise AssertionError(f"two_level: K1 launched "
                             f"{rec['launches']['land_max']} times in "
                             f"{rec['steps']} steps")
    rec.update(flat_ms_per_step=flat_rec["ms_per_step"],
               flat_exchange_share=flat_rec["exchange_share"],
               promotions=[int(m["cafe_promotions"]) for m in metrics],
               max_abs_diff={k: v for k, v in gaps.items() if v},
               integer_state_equal=True, routing_equal=True,
               mesh_shape=list(mesh_two.shape))
    return {"cafe": rec, "hash_unique_compact": phase_unique_compact(
        build_all, from_reference, to_numpy, Config, data, batches,
        mesh_two, fence, methods=("hash",))["hash"]}


def phase_wire_audit(wire_audit, make_criteo_arrays, device="cuda"):
    """cafe_tpu_torch.tools.wire_audit in this process at world size 1 on
    the CLI_ROWS memmap with the headline's CLI flags: the explicit
    exchange, the (1, 1) two-level mesh and auto. Each must pass its
    O(batch) bound; its table goes to OUT_DIR/tools_wire_audit.txt. A
    mesh of one prices the payloads: nothing crosses a wire."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_audit_",
                            dir=os.path.join(here, "build"))
    out = {}
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        plat = ["--force_platform", "cpu"] if device == "cpu" else []
        base = CLI_FLAGS + plat + ["--data_path", root,
                                   "--tensor_board_filename", ""]
        with tool_log("wire_audit"):
            for name, extra in (("explicit", []),
                                ("two_level", ["--mesh_inner", "1"]),
                                ("auto", ["--shard_exchange", "auto"])):
                print(f"==== {name}", flush=True)
                res = wire_audit.run_audit(base + extra, 1)
                code = wire_audit.report(res)
                if code:
                    raise AssertionError(f"wire_audit {name}: a collective "
                                         f"exceeds the O(batch) bound")
                big = max(res["collectives"], key=lambda c: c[2])
                out[name] = {"verdict": "PASS", "total_bytes": res["total"],
                             "bound": res["bound"],
                             "table_bytes": res["table_bytes"],
                             "by_axis": res["by_axis"],
                             "collectives": len(res["collectives"]),
                             "largest": big}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the graph recommenders (main_graphrec_torch.py), at the reference's
# widths on synthetic graphs of the reference datasets' sizes
LIGHTGCN_FLAGS = ["--model", "lightgcn", "--dim", "64", "--layers", "3",
                  "--lr", "0.001", "--weight_decay", "1e-4",
                  "--optimizer", "adam", "--bpr_batch", "2048",
                  "--compress_rate", "0.1", "--hot_rate", "0.7",
                  "--topk", "20",
                  # Gowalla's size: 29,858 users, 40,981 items
                  "--synthetic_users", "29858", "--synthetic_items", "40981"]
# the card's threshold: the default 500 promotes few ids or none in an
# epoch of BPR gradient-norm scores (the default_threshold run records
# how many); 50 promotes from the first steps
LIGHTGCN_THRESHOLD = "50"
PINSAGE_FLAGS = ["--model", "pinsage", "--dim", "16", "--layers", "2",
                 "--lr", "0.001", "--optimizer", "adam",
                 "--compress_ratio", "4", "--bpr_batch", "2048",
                 "--topk", "10",
                 # MovieLens-1M's size (the DGL PinSAGE example's data)
                 "--synthetic_users", "6040", "--synthetic_items", "3706"]
PINSAGE_STEPS = "4"           # steps an epoch: the host sampler sets the pace
GRAPHREC_TOL = 1e-5           # card against CPU, f32 (see adam_close)


def land_captured(land, fn):
    """fn() with K1's wrapper recording its inputs: [(enc, keys, n)]."""
    calls, wrapper = [], land.land_max

    def recording(enc, keys, n):
        calls.append((enc.clone(), keys.clone(), n))
        return wrapper(enc, keys, n)

    land.land_max = recording
    try:
        fn()
    finally:
        land.land_max = wrapper
    return calls


def land_real_case(land, enc, keys, n):
    """K1 on the inputs a real insert gave it: bit-equal to its plain
    version, two launches bit-equal, timed beside the plain version, the
    library's scatter_reduce_ and the memory bound."""
    got = land.land_max(enc, keys, n)
    again = land.land_max(enc, keys, n)
    want = land.land_max_plain(enc, keys, n)
    b, c = enc.shape
    err = int((got.long() - want.long()).abs().max()) if n else 0
    if err or not torch.equal(got, again):
        raise AssertionError(f"K1 at {(b, c, n)}: max err {err}, two "
                             f"launches equal {torch.equal(got, again)}")
    row = {"shape": [b, c, n], "kind": "captured", "max_abs_err": err,
           "two_launches_equal": True,
           "lanes_dropped": int(((keys < 0) | (keys >= n)).sum())}
    if enc.device.type == "cuda":
        out_lib = torch.full((n, c), -1, dtype=torch.int32,
                             device=enc.device)
        keep = (keys >= 0) & (keys < n)
        idx = keys[keep].long()[:, None].expand(-1, c).contiguous()
        src = enc[keep].contiguous()
        bms, by = bound_ms((b * c + b + n * c) * 4, b * c)
        row.update(
            ms=time_ms(lambda: land.land_max(enc, keys, n)),
            plain_ms=time_ms(lambda: land.land_max_plain(enc, keys, n)),
            library_ms=time_ms(lambda: out_lib.scatter_reduce_(
                0, idx, src, "amax", include_self=True)),
            bound_ms=bms, bound_by=by)
    return row


def adam_gaps(card, cpu, lr, tol=GRAPHREC_TOL):
    """A rows-Adam table [R, D] and its slots after one step on the card
    and on the CPU: (the largest gaps, whether they hold). Rows whose
    gradient is float noise in either (|m| < 1e-6; Adam moves such a row
    by up to lr whatever the noise) hold within lr + tol, every other row
    within tol; each slot within 1e-3 of its value plus 1e-5 of its
    largest magnitude. The card sums a row's gradient terms with atomics
    in no fixed order: the sum moves by a few ulps of its terms'
    magnitudes, which can dwarf a sum that cancels to near 0, so the
    bound follows the slot's scale; a row updated wrongly or not at all
    is off by its whole value."""
    noise = (np.abs(card["table_m"]).max(1) < 1e-6) \
        | (np.abs(cpu["table_m"]).max(1) < 1e-6)
    d = np.abs(card["table"] - cpu["table"])
    rec = {"table": float(d[~noise].max(initial=0.0)),
           "noise_rows": int(noise.sum()),
           "noise_rows_table": float(d[noise].max(initial=0.0))}
    ok = rec["table"] <= tol and rec["noise_rows_table"] <= lr + tol
    for k in ("table_m", "table_v"):
        gap = np.abs(card[k] - cpu[k])
        rec[k] = float(gap.max())
        rec[k + "_scale"] = float(np.abs(cpu[k]).max())
        ok &= bool((gap <= 1e-3 * np.abs(cpu[k])
                    + 1e-5 * rec[k + "_scale"]).all())
    return rec, bool(ok)


def adam_close(name, card, cpu, lr, tol=GRAPHREC_TOL):
    """adam_gaps' largest gaps; raises where they do not hold."""
    rec, ok = adam_gaps(card, cpu, lr, tol)
    if not ok:
        raise AssertionError(f"{name}: card against CPU {rec}")
    return rec


def _sketch_equal(name, card, cpu):
    for f, v in cpu.items():
        if not np.array_equal(card[f], v):
            raise AssertionError(f"{name}: sketch {f} differs card vs CPU")


def graphrec_cli(main_fn, argv, log_name, kernels):
    """main_graphrec_torch.main(argv): (its result, prints, wall s, every
    kernel's launches in the run, read as it returns). The result's
    "launches_in_graphs" holds each kernel's launches inside graph
    replays in the run."""
    for k in kernels.values():
        k.launches = 0
    before = {n: k.graph_launches for n, k in kernels.items()}
    t0 = time.perf_counter()
    res, lines = run_cli(main_fn, argv, log_name)
    wall = time.perf_counter() - t0
    res["launches_in_graphs"] = {n: k.graph_launches - before[n]
                                 for n, k in kernels.items()}
    return res, lines, wall, {n: k.launches for n, k in kernels.items()}


# K3 launches a train step: LightGCN's layers each sum their messages
# and their gathers' backward, then the part's apply; PinSAGE's three
# position gathers' backward and the apply (the representation step
# takes none)
K3_PER_STEP = {"lightgcn": 2 * 3 + 1, "pinsage": 3 + 1}


def graphrec_graph_gate(name, res, device, model="lightgcn"):
    """A graphrec CLI run on the card: its steps graphed, nothing
    blocking, K1's launches inside graphs equal to the train step's
    replays (one insert a step; the representation step inserts
    nothing) and K3's K3_PER_STEP[model] times them (the sums of
    ops/sparse.segment_rows). Returns the run's capture record."""
    k1 = res["launches_in_graphs"]["land_max"]
    k3 = res["launches_in_graphs"]["rowsum"]
    rec = {"graphed": res["graphed"], "replays": res["replays"],
           "capture_s": res["capture_s"], "k1_in_graphs": k1,
           "k3_in_graphs": k3,
           "capture_blockers": res["capture_blockers"]}
    if device == "cuda" and not (
            res["graphed"] and res["replays"] > 0 and k1 == res["replays"]
            and k3 == K3_PER_STEP[model] * res["replays"]
            and all(e["graphed"] for e in res["epochs"])):
        raise AssertionError(f"{name}: not graphed as it should be {rec}")
    return rec


def rowsum_captured(rowsum, fn):
    """fn() with K3's wrapper recording its distinct inputs (by shape and
    first ids) outside a capture, in call order: [(table, ids, upd)]
    cloned (LightGCN's three layers sum over one set of ids)."""
    calls, wrapper = {}, rowsum.sparse_add_dense_

    def recording(table, ids, upd):
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            key = (tuple(table.shape), tuple(ids.shape),
                   tuple(ids[:8].tolist()))
            if key not in calls:
                calls[key] = (table.clone(), ids.clone(), upd.clone())
        return wrapper(table, ids, upd)

    rowsum.sparse_add_dense_ = recording
    try:
        fn()
    finally:
        rowsum.sparse_add_dense_ = wrapper
    return list(calls.values())


def _repeats(fn, n=4) -> bool:
    """Whether n calls of fn() give bit-equal tensors."""
    first = fn()
    return all(torch.equal(first, fn()) for _ in range(n - 1))


def rowsum_graphrec_cases(rowsum, calls, names):
    """K3 against its plain version (rowsum_case, no stage window) on the
    inputs a graph recommender's step gave it, named in call order; and
    whether the library's routes repeat bit for bit on them
    (`index_add_` and `scatter_add_` into zeros, torch's own index
    backward)."""
    if len(calls) != len(names):
        raise AssertionError(f"K3: {len(calls)} distinct inputs in a step, "
                             f"want {names}")
    out = {}
    for name, (table, ids, upd) in zip(names, calls):
        out[name] = {"role": name, **rowsum_case(rowsum, table, ids, upd,
                                                 stages=False)}
        if table.is_cuda:
            x = torch.zeros_like(table).requires_grad_()
            idx2 = ids.long()[:, None].expand(-1, upd.shape[1])
            out[name].update(
                index_add_repeats=_repeats(lambda: torch.zeros_like(
                    table).index_add_(0, ids.long(), upd)),
                scatter_add_repeats=_repeats(lambda: torch.zeros_like(
                    table).scatter_add_(0, idx2, upd)),
                index_backward_repeats=_repeats(lambda: torch.autograd.grad(
                    x[ids.long()], x, upd)[0]))
    return out


@contextlib.contextmanager
def atomic_sums(model):
    """The graph recommender `model` summing as it did before its sums
    took K3 (the A/B's other arm): gathers with torch's index backward,
    LightGCN's message sum as index_add, the part's apply coalescing in
    float atomics (index_add_ / scatter_add_)."""
    from cafe_tpu_torch.models.graphrec import lightgcn, pinsage
    saved = (lightgcn.gather_rows, lightgcn.segment_rows,
             pinsage.gather_rows, model.part.deterministic_sums)

    def index_sum(values, seg, n):
        return torch.zeros((n,) + tuple(values.shape[1:]),
                           dtype=values.dtype,
                           device=values.device).index_add(0, seg, values)

    lightgcn.gather_rows = pinsage.gather_rows = lambda t, i: t[i]
    lightgcn.segment_rows = index_sum
    model.part.deterministic_sums = False
    try:
        yield
    finally:
        (lightgcn.gather_rows, lightgcn.segment_rows, pinsage.gather_rows,
         model.part.deterministic_sums) = saved


class AtomicStep:
    """A built step whose calls (warm-ups and capture included) run under
    atomic_sums(model); its other attributes are the step's."""

    def __init__(self, step, model):
        self.step, self.model = step, model

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args):
        with atomic_sums(self.model):
            return self.step(*args)


# steps graphed beside eager from one state: untimed first (the graphed
# step's warm-up calls, capture and a first replay), then windows in turns
GRAPHREC_GRAPH_STEPS, GRAPHREC_UNTIMED, GRAPHREC_WINDOW = 20, 4, 4


def _peak(base):
    """Allocated memory: the peak, the peak over `base` (allocated at the
    start) and what stays allocated."""
    return {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_over_start_gb":
                (torch.cuda.max_memory_allocated() - base) / 1e9,
            "held_after_gb": (torch.cuda.memory_allocated() - base) / 1e9}


def graph_pool_gb(step):
    """What the private memory pools of a GraphedStep's graphs hold
    reserved for their replays (the allocator's segments each graph's
    pool owns, torch.cuda.memory_snapshot), GB. The blocks a capture
    frees stay in its pool, so allocated memory does not show them."""
    pools = {tuple(g.graph.pool()) for g in step._graphs.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools) / 1e9


MODES = ("eager", "graphed", "graphed_atomics")


def _order3(windows):
    """The three modes' windows in turns, the order rotated each round."""
    return [MODES[(w + j) % 3] for w in range(windows) for j in range(3)]


def _bit_equal(a, b) -> bool:
    """Two numpy trees (to_numpy's) bit-equal leaf by leaf."""
    la, lb = _np_leaves(a), _np_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.shape == y.shape and x.tobytes() == y.tobytes()
        for (_, x), (_, y) in zip(la, lb))


def graphed_beside_eager(make, call, land, to_numpy):
    """GRAPHREC_GRAPH_STEPS steps eager, graphed, and graphed with the
    sums in float atomics (make(mode) -> (model, step, state), each mode
    from its own copy of one state on one batch; call(step, state) ->
    (state, loss)). Each mode's first GRAPHREC_UNTIMED steps are untimed
    (its peak memory is read over them, the graph's capture and private
    pool included); then windows of GRAPHREC_WINDOW steps in turns
    (_order3), each ending in torch.cuda.synchronize(). Then the graphed
    step replays GRAPHREC_GRAPH_STEPS steps twice more, each run from a
    copy of the start state: the two runs' states and losses must be
    bit-equal (every sum of the step runs in a fixed order). Returns
    (record, {mode: (model, step, state, losses)}): ms a step (median of
    windows, and each window's), capture s, launches per replay, K1's
    and K3's launches inside graphs (held to the replays), peak
    allocated memory, the graph's private pool."""
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    from cafe_tpu_torch.train.step import clone_state
    runs, rec = {}, {}

    def steps(mode, n):
        """n steps of `mode`, counting K1's and K3's launches inside
        graph replays during them."""
        _, step, state, losses, inside = runs[mode]
        k0 = (land.KERNEL.graph_launches, rowsum_module().KERNEL.graph_launches)
        for _ in range(n):
            state, loss = call(step, state)
            losses.append(loss.clone())
        inside[0] += land.KERNEL.graph_launches - k0[0]
        inside[1] += rowsum_module().KERNEL.graph_launches - k0[1]
        runs[mode][2] = state

    starts = {}
    for mode in MODES:
        model, step, state = make(mode)
        starts[mode] = clone_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[mode] = [model, step, state, [], [0, 0]]
        steps(mode, GRAPHREC_UNTIMED)
        torch.cuda.synchronize()
        rec[mode] = {"graphed": bool(step.graphed), **_peak(base),
                     "windows_ms": []}
    windows = (GRAPHREC_GRAPH_STEPS - GRAPHREC_UNTIMED) // GRAPHREC_WINDOW
    for mode in _order3(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(mode, GRAPHREC_WINDOW)
        torch.cuda.synchronize()
        rec[mode]["windows_ms"].append(
            (time.perf_counter() - t0) * 1e3 / GRAPHREC_WINDOW)
    for mode in rec:
        rec[mode]["ms_per_step"] = float(np.median(rec[mode]["windows_ms"]))
        rec[mode]["steps"] = len(runs[mode][3])
    g = runs["graphed"][1]
    k1, k3 = runs["graphed"][4]
    per = g.launches_per_replay()
    rec["graphed"].update(capture_s=g.capture_s, replays=g.replays,
                          launches_per_replay=per, k1_in_graphs=k1,
                          k3_in_graphs=k3, graph_pool_gb=graph_pool_gb(g))
    rec["graphed_atomics"]["capture_s"] = runs["graphed_atomics"][1].capture_s
    rec["k3_over_atomics"] = (rec["graphed"]["ms_per_step"]
                              / rec["graphed_atomics"]["ms_per_step"])
    if not g.graphed or rec["eager"]["graphed"] or \
            not rec["graphed_atomics"]["graphed"] or \
            g.replays != GRAPHREC_GRAPH_STEPS - WARMUP_CALLS or \
            k1 != g.replays * per.get("land_max", 0) or \
            not per.get("rowsum") or k3 != g.replays * per["rowsum"]:
        raise AssertionError(f"graphed beside eager: {rec}")
    losses = [torch.stack(runs[m][3]).double().cpu().numpy() for m in rec
              if m in MODES]
    rec["loss_gap"] = float(np.abs(losses[0] - losses[1]).max())
    first = to_numpy(runs["graphed"][2])
    rec["graphed_vs_eager_bit_equal"] = _bit_equal(
        first, to_numpy(runs["eager"][2]))
    # two more runs of each graph from its start state, replays only
    # (the step's state is the graph's own, so this overwrites the first
    # run's, which `first` keeps): the graphed step's bit for bit; the
    # atomics' recorded
    def two_runs(mode):
        step, out = runs[mode][1], []
        for _ in range(2):
            st, ls = clone_state(starts[mode]), []
            for _ in range(GRAPHREC_GRAPH_STEPS):
                st, loss = call(step, st)
                ls.append(loss.clone())
            out.append((to_numpy(st), torch.stack(ls).cpu().numpy()))
        return out, (_bit_equal(out[0][0], out[1][0])
                     and out[0][1].tobytes() == out[1][1].tobytes())

    again, equal = two_runs("graphed")
    rec["two_graphed_runs"] = {"steps": GRAPHREC_GRAPH_STEPS,
                               "bit_equal": equal}
    if not equal:
        raise AssertionError(f"two graphed runs from one state differ: "
                             f"{rec['two_graphed_runs']}")
    rec["two_graphed_runs"]["equal_to_the_first"] = _bit_equal(
        again[0][0], first)
    rec["graphed_atomics"]["two_runs_bit_equal"] = two_runs(
        "graphed_atomics")[1]
    del again, starts, first
    return rec, {m: runs[m][:4] for m in runs}


def rowsum_module():
    from cafe_tpu_torch.kernels import rowsum
    return rowsum


def sum_launches(runs):
    """{kernel: launches} summed over the runs' `launches` dicts."""
    return {n: sum(r["launches"][n] for r in runs)
            for n in runs[0]["launches"]}


def phase_graphrec_lightgcn(gr, land, load_tree, to_numpy, kernels,
                            flags=LIGHTGCN_FLAGS, device="cuda",
                            threshold=LIGHTGCN_THRESHOLD):
    """LightGCN at the reference's width (dim 64, 3 layers, Adam, cr 0.1)
    on a synthetic graph of Gowalla's size: one epoch at the default
    threshold 500 (its hot ids recorded), then at `threshold` one
    epoch saved and a second run that auto-resumes and trains one more;
    K1 once a step, K3 K3_PER_STEP times, recall@20 above a random
    ranking's. Then K1 and K3 on the inputs a step of the trained state
    gives them, and one step from that state (frequency scores) on the
    card and on the CPU: the sketch exact, the table and its Adam slots
    within adam_close. Each CLI run graphs its step (graphrec_graph_gate);
    on the card the step is then timed graphed beside eager from that
    state (lightgcn_graphed)."""
    plat = ["--force_platform", "cpu"] if device == "cpu" else []
    root = tempfile.mkdtemp(prefix="chip_smoke_lightgcn_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        out = {}
        for name, extra in (
                ("default_threshold", ["--epochs", "1"]),
                ("run_a", ["--epochs", "1", "--save_dir", root,
                           "--sketch_threshold", threshold]),
                ("run_b", ["--epochs", "2", "--save_dir", root,
                           "--sketch_threshold", threshold])):
            res, lines, wall, launches = graphrec_cli(
                gr.main, flags + plat + extra, f"graphrec_lightgcn_{name}.txt",
                kernels)
            k1 = launches["land_max"]
            ep = res["epochs"][-1]
            random_recall = 20 / int(flags[flags.index(
                "--synthetic_items") + 1])
            if len(res["epochs"]) != 1 or not (
                    np.isfinite(ep["loss"]) and ep["recall"] > random_recall):
                raise AssertionError(f"lightgcn {name}: {res}")
            if device == "cuda" and (
                    k1 != ep["steps"] or launches["rowsum"]
                    < K3_PER_STEP["lightgcn"] * ep["steps"]):
                raise AssertionError(f"lightgcn {name}: K1 launched {k1}, "
                                     f"K3 {launches['rowsum']} times in "
                                     f"{ep['steps']} steps")
            out[name] = {**ep, "wall_s": wall, "launches": launches,
                         "launches_in_graphs": res["launches_in_graphs"],
                         "capture": graphrec_graph_gate(
                             f"lightgcn {name}", res, device),
                         "lines": [ln for ln in lines
                                   if ln.startswith(("epoch", "resumed"))]}
        if not any(ln.startswith("resumed from") and "epoch_0.ckpt" in ln
                   for ln in out["run_b"]["lines"]) \
                or out["run_b"]["epoch"] != 1 or out["run_a"]["hot_ids"] <= 0:
            raise AssertionError(f"lightgcn resume: {out['run_b']}")
        runs = [out[n] for n in ("default_threshold", "run_a", "run_b")]
        out["launches"] = sum_launches(runs)
        out["launches_in_graphs"] = sum_launches(
            [{"launches": r["launches_in_graphs"]} for r in runs])

        args = gr.parse_args(flags + ["--sketch_threshold", threshold])
        train, _, n_items = gr.make_synthetic_interactions(
            args.synthetic_users, args.synthetic_items, seed=args.seed)
        rng = np.random.default_rng(0)
        users = rng.integers(0, len(train), args.bpr_batch)
        pos = np.array([train[u][0] for u in users], np.int32)
        neg = rng.integers(0, n_items, args.bpr_batch).astype(np.int32)
        ck = os.path.join(root, "lightgcn_epoch_1.ckpt")
        steps = {}
        for dev in dict.fromkeys([device, "cpu"]):
            model = gr.lightgcn_model(args, train, n_items, dev)
            model.part.use_freq = True
            state, _ = load_tree(ck, model.init(), model.device)
            new, k3 = [], []
            calls = land_captured(land, lambda: k3.extend(rowsum_captured(
                rowsum_module(), lambda: new.append(model.bpr_step(
                    state, users, pos, neg)[0]))))
            steps[dev] = (to_numpy(new[0]), calls)
            if dev == "cuda":
                # the first layer's message sum (by destination), the
                # first gathers' backward (by source), the apply
                out["rowsum_cases"] = rowsum_graphrec_cases(
                    rowsum_module(), k3, ["messages_by_dst",
                                          "gather_backward_by_src",
                                          "apply_coalesce"])
                del k3
                batch = [torch.from_numpy(x).cuda() for x in (users, pos,
                                                              neg)]

                def one(i):
                    new[0] = model.bpr_step(new[0], *batch)[0]

                one(0)
                out["profile"] = trace_steps("graphrec_lightgcn", one)
            del model, state, new
        (card, calls), (cpu, _) = steps[device], steps["cpu"]
        out["land_max_cases"] = [land_real_case(land, *c) for c in calls]
        _sketch_equal("lightgcn", card["sketch"], cpu["sketch"])
        if card["tick"] != cpu["tick"]:
            raise AssertionError("lightgcn: tick differs card vs CPU")
        out["card_vs_cpu"] = adam_close("lightgcn", card, cpu, args.lr)
        out["card_vs_cpu"]["sketch_equal"] = True
        if device == "cuda":
            batch = [torch.from_numpy(x).cuda().long()
                     for x in (users, pos, neg)]
            out["graphed_beside_eager"] = lightgcn_graphed(
                gr, land, load_tree, to_numpy, args, train, n_items, ck,
                batch)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lightgcn_graphed(gr, land, load_tree, to_numpy, args, train, n_items,
                     ck, batch):
    """LightGCN.build_step graphed beside eager (and beside its graph
    with the sums in float atomics) from the checkpoint's state on one
    batch (graphed_beside_eager, frequency scores): two graphed runs
    bit-equal, the sketch, tick and hot ids exact, the table and its
    Adam slots within adam_close; then the graphed step traced."""
    def make(mode):
        model = gr.lightgcn_model(args, train, n_items, "cuda")
        model.part.use_freq = True
        state, _ = load_tree(ck, model.init(), model.device)
        if mode == "graphed_atomics":
            with atomic_sums(model):
                return model, AtomicStep(model.build_step(True), model), \
                    state
        return model, model.build_step(mode == "graphed"), state

    rec, runs = graphed_beside_eager(
        make, lambda step, state: step(state, *batch), land, to_numpy)
    (_, _, e, _), (_, g_step, g, _) = runs["eager"], runs["graphed"]
    e_np, g_np = to_numpy(e), to_numpy(g)
    _sketch_equal("lightgcn graphed", g_np["sketch"], e_np["sketch"])
    rec["hot_ids"] = [gr.hot_ids(g), gr.hot_ids(e)]
    if g_np["tick"] != e_np["tick"] or rec["hot_ids"][0] != rec["hot_ids"][1]:
        raise AssertionError(f"lightgcn graphed: tick or hot ids differ "
                             f"from eager {rec}")
    rec["graphed_vs_eager"] = {**adam_close("lightgcn graphed", g_np, e_np,
                                            args.lr), "sketch_equal": True}
    rec["profile_graph"] = trace_steps("graphrec_lightgcn_graph",
                                       lambda i: g_step(g, *batch))
    return rec


def pinsage_dense_gaps(card, ref):
    """PinSAGE's conv params and their optimizer slots against `ref`'s:
    {key: the largest gap of each leaf}."""
    return {key: [float(np.max(np.abs(np.asarray(a) - np.asarray(c))))
                  for a, c in zip(_flat(card[key]), _flat(ref[key]))]
            for key in [k for k in ref if k.startswith("conv")] + ["opt"]}


def pinsage_dense_close(name, card, ref):
    """PinSAGE's conv params and their optimizer slots within
    GRAPHREC_TOL of `ref`'s: {key: the largest gap}."""
    rec = {}
    for key, gaps in pinsage_dense_gaps(card, ref).items():
        rec[key] = max(gaps)
        if not rec[key] <= GRAPHREC_TOL:
            raise AssertionError(f"{name} {key}: {gaps}")
    return rec


def phase_graphrec_pinsage(gr, land, load_tree, to_numpy, kernels,
                           flags=PINSAGE_FLAGS, device="cuda"):
    """PinSAGE at the reference's width (hidden 16, 2 layers, T = 3, 10
    walks, Adam) with CAFE (compress ratio 4) on a synthetic graph of
    MovieLens-1M's size at B = 2048 (79,872 padded ids a step):
    PINSAGE_STEPS steps an epoch, one epoch saved, then a run that
    auto-resumes and trains one more; hit@10 and NDCG; the host sampler
    timed apart from the device step; K1 once a step. Then K1 on the
    inputs a step of the trained state gives it, and one step from that
    state and one block (frequency scores) on the card and on the CPU:
    the sketch exact, conv params and their Adam slots within
    GRAPHREC_TOL, the table within adam_close. Each CLI run graphs its
    train and representation steps (graphrec_graph_gate); on the card
    they are then held graphed beside eager (pinsage_graphed)."""
    plat = ["--force_platform", "cpu"] if device == "cpu" else []
    root = tempfile.mkdtemp(prefix="chip_smoke_pinsage_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        out = {}
        for name, epochs in (("run_a", "1"), ("run_b", "2")):
            res, lines, wall, launches = graphrec_cli(
                gr.main, flags + plat + ["--epochs", epochs, "--save_dir",
                                         root, "--steps_per_epoch",
                                         PINSAGE_STEPS],
                f"graphrec_pinsage_{name}.txt", kernels)
            k1 = launches["land_max"]
            ep = res["epochs"][-1]
            if len(res["epochs"]) != 1 or not (
                    np.isfinite(ep["loss"]) and 0 < ep["hit"] <= 1
                    and 0 < ep["ndcg"] <= 1):
                raise AssertionError(f"pinsage {name}: {res}")
            if device == "cuda" and (
                    k1 != ep["steps"] or launches["rowsum"]
                    < K3_PER_STEP["pinsage"] * ep["steps"]):
                raise AssertionError(f"pinsage {name}: K1 launched {k1}, "
                                     f"K3 {launches['rowsum']} times in "
                                     f"{ep['steps']} steps")
            out[name] = {**ep, "wall_s": wall, "launches": launches,
                         "launches_in_graphs": res["launches_in_graphs"],
                         "capture": graphrec_graph_gate(
                             f"pinsage {name}", res, device, "pinsage"),
                         "representation": res["representation"],
                         "lines": [ln for ln in lines
                                   if ln.startswith(("epoch", "resumed"))]}
            if device == "cuda" and not res["representation"]["graphed"]:
                raise AssertionError(f"pinsage {name}: the representation "
                                     f"step ran eagerly {res}")
        if not any(ln.startswith("resumed from") and "epoch_0.ckpt" in ln
                   for ln in out["run_b"]["lines"]) \
                or out["run_b"]["epoch"] != 1:
            raise AssertionError(f"pinsage resume: {out['run_b']}")
        runs = [out["run_a"], out["run_b"]]
        out["launches"] = sum_launches(runs)
        out["launches_in_graphs"] = sum_launches(
            [{"launches": r["launches_in_graphs"]} for r in runs])

        args = gr.parse_args(flags)
        train, _, n_items = gr.make_synthetic_interactions(
            args.synthetic_users, args.synthetic_items, seed=args.seed)
        ck = os.path.join(root, "pinsage_epoch_1.ckpt")
        block, steps = None, {}
        for dev in dict.fromkeys([device, "cpu"]):
            model, sampler = gr.pinsage_model(args, train, n_items, dev)
            model.part.use_freq = True
            state, _ = load_tree(ck, model.init(), model.device)
            if block is None:
                block = {k: v.cpu() for k, v in model.make_batch(
                    sampler, args.bpr_batch).items()}
            b = {k: v.to(model.device) for k, v in block.items()}
            new, k3 = [], []
            calls = land_captured(land, lambda: k3.extend(rowsum_captured(
                rowsum_module(), lambda: new.append(model.train_step(
                    state, b, args.lr)[0]))))
            steps[dev] = (to_numpy(new[0]), calls)
            if dev == "cuda":       # the device step alone: one block
                # the backward of the gathers at the seed, 1-hop and
                # 2-hop positions (S, S*T, S*T*T lanes), then the apply
                # over the block's padded ids (more lanes than any)
                out["rowsum_cases"] = rowsum_graphrec_cases(
                    rowsum_module(), sorted(k3, key=lambda c: c[1].numel()),
                    ["gather_backward_ego", "gather_backward_nbr1",
                     "gather_backward_nbr2", "apply_coalesce"])
                del k3

                def one(i):
                    new[0] = model.train_step(new[0], b, args.lr)[0]

                one(0)
                out["profile"] = trace_steps("graphrec_pinsage", one)
            del model, state, new
        (card, calls), (cpu, _) = steps[device], steps["cpu"]
        out["land_max_cases"] = [land_real_case(land, *c) for c in calls]
        _sketch_equal("pinsage", card["embed"]["sketch"],
                      cpu["embed"]["sketch"])
        rec = adam_close("pinsage", card["embed"], cpu["embed"], args.lr)
        rec.update(pinsage_dense_close("pinsage card against CPU", card,
                                       cpu))
        out["card_vs_cpu"] = {**rec, "sketch_equal": True}
        if device == "cuda":
            out["graphed_beside_eager"] = pinsage_graphed(
                gr, land, load_tree, to_numpy, args, train, n_items, ck,
                {k: v.cuda() for k, v in block.items()})
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def graphed_lockstep(g_step, e_step, state, call, close, to_numpy,
                     steps=GRAPHREC_GRAPH_STEPS):
    """`steps` steps from `state` in lockstep: at each, the graphed step
    replays from a copy of the eager step's input (GraphedStep's copy-in
    of a foreign state), then the eager step takes that input, and
    close(graphed, eager) (numpy trees) holds the two results and
    returns their gaps. Both read one state, so their forward passes
    agree and only the backward's atomic sums differ, by ulps that one
    step's bound holds at every step. A free run on one repeated batch
    lets those ulps grow from step to step: two graphed runs from one
    state part as far as a graphed and an eager run do. Returns the
    largest of each gap and of the loss gap over the steps."""
    from cafe_tpu_torch.train.step import clone_state
    worst = {"loss_gap": 0.0}
    for _ in range(steps):
        g, g_loss = call(g_step, clone_state(state))
        g_np, g_loss = to_numpy(g), float(g_loss)
        state, e_loss = call(e_step, state)
        gaps = close(g_np, to_numpy(state))
        gaps["loss_gap"] = abs(g_loss - float(e_loss))
        worst = {k: max(v, worst.get(k, v)) for k, v in gaps.items()}
    return {**worst, "steps": steps}


def pinsage_graphed(gr, land, load_tree, to_numpy, args, train, n_items,
                    ck, block):
    """PinSAGE's built train step graphed beside eager (and beside its
    graph with the sums in float atomics) from the checkpoint's state on
    one block (graphed_beside_eager, frequency scores): two graphed runs
    bit-equal; the sketch, tick and hot ids exact, the free run's table
    and its Adam slots within adam_close, conv params and slots within
    GRAPHREC_TOL (whether they are bit-equal recorded); then
    GRAPHREC_GRAPH_STEPS steps in lockstep from the eager run's state
    (graphed_lockstep), each with the same gates; represent_items
    through the graphed representation step against the eager one on
    the graphed state, within GRAPHREC_TOL (bit-equal expected); then
    the graphed train step traced."""
    from cafe_tpu_torch.models.graphrec.pinsage import block_args
    blk = block_args(block)

    def make(mode):
        model, _ = gr.pinsage_model(args, train, n_items, "cuda")
        model.part.use_freq = True
        state, _ = load_tree(ck, model.init(), model.device)
        if mode == "graphed_atomics":
            with atomic_sums(model):
                return model, AtomicStep(
                    model.build_train_step(args.lr, True), model), state
        return model, model.build_train_step(args.lr, mode == "graphed"), \
            state

    def call(step, state):
        return step(state, *blk, args.lr)

    rec, runs = graphed_beside_eager(make, call, land, to_numpy)
    (_, e_step, e, _), (model, g_step, g, _) = (runs["eager"],
                                                runs["graphed"])
    e_np, g_np = to_numpy(e), to_numpy(g)
    _sketch_equal("pinsage graphed", g_np["embed"]["sketch"],
                  e_np["embed"]["sketch"])
    rec["hot_ids"] = [gr.hot_ids(g["embed"]), gr.hot_ids(e["embed"])]
    if g_np["embed"]["tick"] != e_np["embed"]["tick"] or \
            rec["hot_ids"][0] != rec["hot_ids"][1]:
        raise AssertionError(f"pinsage graphed: tick or hot ids differ "
                             f"from eager {rec}")
    free = adam_close("pinsage graphed free run", g_np["embed"],
                      e_np["embed"], args.lr)
    free.update(pinsage_dense_close("pinsage graphed free run", g_np,
                                    e_np))
    rec["free_run"] = {**free, "bit_equal": rec["graphed_vs_eager_bit_equal"]}

    def close(g_np, e_np):
        _sketch_equal("pinsage graphed step", g_np["embed"]["sketch"],
                      e_np["embed"]["sketch"])
        if g_np["embed"]["tick"] != e_np["embed"]["tick"]:
            raise AssertionError("pinsage graphed step: tick differs")
        gaps = adam_close("pinsage graphed step", g_np["embed"],
                          e_np["embed"], args.lr)
        gaps.update(pinsage_dense_close("pinsage graphed step", g_np,
                                        e_np))
        return gaps

    rec["graphed_vs_eager"] = {
        **graphed_lockstep(g_step, e_step, e, call, close, to_numpy),
        "sketch_equal": True}
    reps, rep_rec = {}, {}
    for mode in ("graphed", "eager"):
        _, sampler = gr.pinsage_model(args, train, n_items, "cpu")
        rep = model.build_representation_step(mode == "graphed")
        t0 = time.perf_counter()
        reps[mode] = model.represent_items(g, sampler, step=rep)
        rep_rec[f"{mode}_s"] = time.perf_counter() - t0
        if rep.graphed:
            rep_rec.update(replays=rep.replays, capture_s=rep.capture_s)
    rep_rec["max_abs_gap"] = float(np.abs(reps["graphed"]
                                          - reps["eager"]).max())
    rep_rec["bit_equal"] = bool(np.array_equal(reps["graphed"],
                                               reps["eager"]))
    if not rep_rec.get("replays") or \
            not rep_rec["max_abs_gap"] <= GRAPHREC_TOL:
        raise AssertionError(f"pinsage represent_items graphed against "
                             f"eager: {rep_rec}")
    rec["represent_items"] = rep_rec
    rec["profile_graph"] = trace_steps(
        "graphrec_pinsage_graph", lambda i: g_step(g, *blk, args.lr))
    return rec


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def load_tool(name):
    """A root tool script (tools/<name>.py) as a module."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_root(name):
    """A root script (<name>.py beside this one) as a module."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def tool_log(name):
    """A tool's own prints, kept in chiprun_out/tools_<name>.txt."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"tools_{name}.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        yield


AB_WINDOWS, AB_STEPS = 2, 20


def check_donate_off(build_all, build_multi_step, Config, data, batches,
                     device="cuda"):
    """The donate_off arm of decision 1: one 8-step dispatch from a state
    leaves that state's tensors unchanged on the card."""
    from cafe_tpu_torch.utils.timing import fence
    cfg = headline_cfg(Config, donate_state=False)
    _, _, state, step, _ = build_all(cfg, data, device=device)
    multi = build_multi_step(step, 8, donate=False)
    fused = tuple(torch.cat([b[j] for b in batches[:8]]) for j in range(3))
    table0 = state.embed["part0"]["table"].clone()
    cnt0 = state.embed["part0"]["sketch"]["cnt"].clone()
    w0 = state.params["top"][0]["w"].clone()
    new, _ = multi(state, *fused, 8 * 2048)
    fence(new)
    unchanged = (torch.equal(state.embed["part0"]["table"], table0)
                 and torch.equal(state.embed["part0"]["sketch"]["cnt"], cnt0)
                 and torch.equal(state.params["top"][0]["w"], w0))
    moved = not torch.equal(new.embed["part0"]["table"], table0)
    if not (unchanged and moved):
        raise AssertionError(f"donate_off: input unchanged {unchanged}, "
                             f"output moved {moved}")
    return {"input_state_unchanged": True, "output_moved": True}


def phase_ab_decisions(ab, kernels, donate_check):
    """The four decisions at full width, AB_WINDOWS x AB_STEPS each, with
    each one's launch counts checked (module docstring, phase 14)."""
    warm, timed = ab.WARMUP, AB_WINDOWS * AB_STEPS
    k = ab.DISPATCH_K
    steps_1 = 2 * (warm + AB_WINDOWS * (AB_STEPS // k)) * k
    want = {1: {"land_max": steps_1, "gather": 0},
            2: {"land_max": 2 * (warm + timed),
                "scatter_add": 2 * (warm + timed), "gather": 0},
            3: {"land_max": 2 * (warm + timed), "gather": 0},
            4: {"gather": warm + timed, "land_max": 0}}
    rec = {"windows": AB_WINDOWS, "steps": AB_STEPS,
           "donate_off_check": donate_check, "decisions": [],
           "launches": {name: 0 for name in kernels}}
    for d in (1, 2, 3, 4):
        for kern in kernels.values():
            kern.launches = 0
        with tool_log(f"ab_decisions_{d}"):
            line = ab.DECISIONS[d](AB_WINDOWS, steps=AB_STEPS,
                                   device="cuda")
        torch.cuda.empty_cache()
        launches = {name: kern.launches for name, kern in kernels.items()}
        bad = {n: (launches[n], v) for n, v in want[d].items()
               if launches[n] != v}
        if bad:
            raise AssertionError(f"ab_decisions {d}: launches (got, want) "
                                 f"{bad}")
        rec["decisions"].append({**line, "launches": launches})
        for name, v in launches.items():
            rec["launches"][name] += v
    return rec


def phase_ab_insert_land(land_tool, kernels):
    """tools/ab_insert_land_torch.py at full width (module docstring,
    phase 15); the tool itself raises if an arm's state differs."""
    for kern in kernels.values():
        kern.launches = 0
    args = land_tool.parse_args(["--windows", str(AB_WINDOWS), "--steps",
                                 str(AB_STEPS)])
    with tool_log("ab_insert_land"):
        records = land_tool.run(args)
    torch.cuda.empty_cache()
    launches = {name: kern.launches for name, kern in kernels.items()}
    eq = [r for r in records if r["level"] == "equal_state"]
    if [r["impl"] for r in eq] != land_tool.IMPLS[1:] or not all(
            r["equal"] for r in eq):
        raise AssertionError(f"ab_insert_land: equal_state {eq}")
    # the pallas arm's inserts only: 6 warm-up + windows x steps at
    # level 1 and again at level 2, and the 4 inserts of the check
    want = 2 * (6 + AB_WINDOWS * AB_STEPS) + 4
    if launches["land_max"] != want:
        raise AssertionError(f"ab_insert_land: K1 launched "
                             f"{launches['land_max']} times, not {want}")
    return {"windows": AB_WINDOWS, "steps": AB_STEPS, "records": records,
            "launches": launches}


def phase_roofline(roofline, kernels):
    """cafe_tpu_torch.tools.roofline at its defaults (phase 16)."""
    for kern in kernels.values():
        kern.launches = 0
    with tool_log("roofline"):
        out = roofline.main([])
    torch.cuda.empty_cache()
    launches = {name: kern.launches for name, kern in kernels.items()}
    iters = 100
    if launches["scatter_add"] != 2 * iters:
        raise AssertionError(f"roofline: K2 launched "
                             f"{launches['scatter_add']} times, not "
                             f"{2 * iters} (optimizer_apply)")
    fracs = {k: v["frac_of_peak"] for k, v in out.items()
             if isinstance(v, dict) and "frac_of_peak" in v}
    stages = [v for v in out.values() if isinstance(v, dict) and "ms" in v]
    if not all(f <= 1.05 for f in fracs.values()) or not all(
            v["ms"] > 0 for v in stages):
        raise AssertionError(f"roofline: a share of the peak above 1.05 "
                             f"(the window's clock is wrong) or a stage "
                             f"without time: {out}")
    return {**out, "launches": launches}


METHOD_STEPS, METHOD_WINDOWS = 20, 3
AE_MAX_IND_RANGE = 65536      # bounds AE pretraining's [B, F, vocab] logits
GATE_STEPS = 3                # 2 warm-up calls and a replay when graphed
DENSE_TOL = 1e-3              # phase_parity's bound for bf16 towers
AE_TOL = 1e-5                 # f32 pretraining, cuBLAS against the CPU


def method_configs(Config):
    """{name: (phase, config)}: the methods at the headline flags (dense
    apply), QR and AdaEmbed at the sibling's, the towers over CAFE."""
    dense = dict(sparse_apply_impl="dense")
    sib = dict(dataset="criteotb", embedding_dim=128, compress_rate=0.1,
               learning_rate=1.0)
    return {
        "qr_add": ("methods", headline_cfg(Config, compress_method="qr",
                                           **dense)),
        "qr_mult": ("methods", headline_cfg(
            Config, compress_method="qr", qr_operation="mult", **dense)),
        "qr_concat": ("methods", headline_cfg(
            Config, compress_method="qr", qr_operation="concat", **dense)),
        "mde": ("methods", headline_cfg(Config, compress_method="mde",
                                        **dense)),
        "off": ("methods", headline_cfg(Config, compress_method="off",
                                        **dense)),
        "hash_weighted": ("methods", headline_cfg(
            Config, compress_method="hash", weighted_pooling="learned",
            **dense)),
        "ae": ("methods", headline_cfg(
            Config, compress_method="ae", max_ind_range=AE_MAX_IND_RANGE,
            **dense)),
        "qr_sibling": ("methods", headline_cfg(Config, compress_method="qr",
                                               **sib)),
        "ada_sibling": ("methods", headline_cfg(
            Config, compress_method="ada", **sib)),
        "wdl": ("towers", headline_cfg(Config, model="wdl", **dense)),
        "dcn": ("towers", headline_cfg(Config, model="dcn", **dense)),
    }


def sparse_updates(part, st, ids, g, aux, lr):
    """[(state key, rows [M], per-lane change [M, d])] of every table
    part.apply_grads scatter-adds into (SGD), computed as it computes
    them: the oracle of gate_card_cpu's bound (and of its kernel
    count)."""
    kind = type(part).__name__
    if kind == "QRPart":
        qi, ri = aux[:2]
        if part.operation == "mult":
            gq, gr = g * aux[3], g * aux[2]
        elif part.operation == "concat":
            gq, gr = g[..., :part.q_dim], g[..., part.q_dim:]
        else:
            gq = gr = g
        out = [("q", qi, -lr * gq), ("r", ri, -lr * gr)]
    elif kind == "HashedTablePart" and part.weighted:
        learned = part.weighted == "learned"
        widx = part._w_index(ids)
        out = [("table", aux[0] if learned else aux,
                -lr * g * st["w"][widx.long()])]
        if learned:
            out.append(("w", widx, -lr * (g * aux[1]).sum(-1,
                                                          keepdim=True)))
    elif kind == "AdaPart":
        gid, rows = aux
        norms = torch.sqrt((g * g).sum(-1) + 1e-30)
        norms = norms * g.shape[0] / (norms.sum(0, keepdim=True) + 1e-30)
        out = [("weight", torch.where(rows > 0, rows, st["weight"].shape[0]),
                -lr * g), ("grad_norm", gid, norms[..., None])]
    elif kind == "AEGroupPart":
        out = []                                  # frozen
    else:
        rows = {"OffPart": lambda a: a[0], "CafePart": lambda a: a[1]}.get(
            kind, lambda a: a)(aux)
        out = [("table", rows, -lr * g)]
    return [(key, rows.reshape(-1), upd.reshape(rows.numel(), -1))
            for key, rows, upd in out]


def predicted_launches(embed, state, batch):
    """Kernel launches one step of `embed` makes, by the apply routes of
    ops/sparse.py: K2 or K3 per scatter-added table, K1 per v1 CAFE part."""
    from cafe_tpu_torch.ops.sparse import _use_dense_rowsum, _use_pallas_apply
    out = {"land_max": 0, "scatter_add": 0, "rowsum": 0}
    for i, p in enumerate(embed.parts):
        st = state.embed[f"part{i}"]
        lanes = batch * len(p.field_idx)
        keys = {"QRPart": ("q", "r"), "AdaPart": ("weight",),
                "AEGroupPart": ()}.get(type(p).__name__, ("table",))
        if getattr(p, "weighted", "") == "learned":
            keys += ("w",)
        for key in keys:
            n, d = st[key].shape
            if _use_pallas_apply(n, d, p.apply_impl):
                out["scatter_add"] += 1
            elif _use_dense_rowsum(n, d, lanes, p.apply_impl):
                out["rowsum"] += 1
        out["land_max"] += type(p).__name__ == "CafePart" and not p.plus
    return out


def phase_method(build_all, fence, cfg, data, batches, kernels,
                 pretrain=None):
    """One configuration through build_all on the card (graphed where
    train/step.capture_blockers is empty): AE pretraining first when
    `pretrain`, then the first step timed alone (AdaEmbed's check and
    rebuild run in it), WARMUP_CALLS more (a graphed step captures on
    the last), METHOD_WINDOWS windows of METHOD_STEPS steps ended by a
    synchronize. Each kernel must launch as predicted_launches says, each
    step. Returns (embed, state, record)."""
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    _, embed, state, step, _ = build_all(cfg, data, device="cuda")
    fence(state)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    rec = {"allocated_before_gb": before / 2**30,
           "state_gb": (torch.cuda.memory_allocated() - before) / 2**30,
           "graphed": bool(step.graphed),
           "capture_blockers": list(getattr(step, "capture_blockers", [])),
           "parts": [type(p).__name__ for p in embed.parts]}
    if pretrain is not None:
        t0 = time.perf_counter()
        rec["pretrain_batches"] = pretrain(embed, state, data, "cuda")
        fence(state)
        rec["pretrain_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state, m = step(state, *batches[0])
    fence(state, m)
    rec["first_step_ms"] = (time.perf_counter() - t0) * 1e3
    n = 1
    for _ in range(WARMUP_CALLS):
        state, m = step(state, *batches[n % len(batches)])
        n += 1
    fence(state, m)
    win = []
    for _ in range(METHOD_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(METHOD_STEPS):
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        win.append((time.perf_counter() - t0) * 1e3 / METHOD_STEPS)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    launches = {name: k.launches for name, k in kernels.items()}
    per_step = predicted_launches(embed, state, cfg.mini_batch_size)
    want = {name: v * n for name, v in per_step.items()}
    if any(launches[name] != v for name, v in want.items()):
        raise AssertionError(f"launches {launches}, predicted {want}")
    ms = float(np.median(win))
    rec.update(
        steps=n, ms_per_step=ms, window_ms=win,
        examples_per_s=cfg.mini_batch_size * 1e3 / ms, loss=loss,
        # the configuration's own: above what was allocated before it
        peak_allocated_gb=(torch.cuda.max_memory_allocated() - before)
        / 2**30,
        launches=launches, launches_per_step=per_step,
        kernels_launched=sorted(k for k, v in launches.items() if v),
        stats={k: float(v) for k, v in m.items()
               if k not in ("loss", "correct", "weight")})
    return embed, state, rec


def _pairs(card, cpu):
    """(path, card leaf, CPU leaf) of two state trees, as numpy."""
    from cafe_tpu_torch.utils.cond import _leaves
    return [(path, a.detach().cpu().numpy(), b.detach().numpy())
            for (path, a), (_, b) in zip(_leaves(card), _leaves(cpu))]


def gate_card_cpu(build_all, from_reference, to_numpy, bce, cfg, data,
                  batches, batches_cpu, pretrain=None, pre_steps=0,
                  meshes=(None, None), steps=GATE_STEPS):
    """`steps` steps of `cfg` on the card (build_all's default step)
    and on the CPU, each step from one state (the card's, copied to the
    CPU before it); AE pretraining first when `pretrain`, `pre_steps`
    card steps first (a CAFE+ sketch near its reset's trip). For a CAFE+
    part the record counts the resets and decays of the gated steps.

    * integer state (Off's hot_dict, AdaEmbed's dic and step, the CAFE
      sketch) and the rows both route the batch to after the step:
      exactly equal;
    * each scatter-added table (sparse_updates): within twice the f32
      reordering bound of its scatter-add (reorder_bound) plus, per row,
      the sum of |card - CPU| of the lane updates it received (the lane
      gradients come from each device's towers, lane_grads);
    * every other float leaf of the embedding state: bit-equal; dense
      params and projections within DENSE_TOL, the AE tensors after
      pretraining within AE_TOL.
    AdaEmbed's step 1 rebuilds on both (nothing is admitted, so every
    sample churns); the samples themselves differ (CPU and CUDA
    generators). `meshes`: (the card's, the CPU's) meshes of one rank
    to build both sides on."""
    g_model, g_embed, g_state, g_step, _ = build_all(cfg, data,
                                                     device="cuda",
                                                     mesh=meshes[0])
    c_model, c_embed, _, c_step, _ = build_all(cfg, data, device="cpu",
                                               capture=False,
                                               mesh=meshes[1])
    lr = cfg.learning_rate
    rec = {"steps": steps, "graphed": bool(g_step.graphed),
           "max_abs_diff": {}, "max_share_of_bound": {}}
    fires = {"reset": 0, "decay": 0}
    for i in range(pre_steps):
        g_state, _ = g_step(g_state, *batches[i % len(batches)])

    def worse(d, key, v):
        d[key] = max(d.get(key, 0.0), v)

    if pretrain is not None:
        c_state = cpu_copy(g_state)
        pretrain(g_embed, g_state, data, "cuda")
        pretrain(c_embed, c_state, data, "cpu")
        for path, a, b in _pairs(g_state.embed, c_state.embed):
            diff = float(np.abs(a - b).max()) if a.size else 0.0
            worse(rec["max_abs_diff"], "pretrain" + path, diff)
            if not diff <= AE_TOL:
                raise AssertionError(f"pretraining: {path} differs by "
                                     f"{diff} > {AE_TOL}")
    for i in range(steps):
        for j, part in enumerate(g_embed.parts):
            count_fires(fires, part, g_state.embed[f"part{j}"].get("sketch"))
        c_state = cpu_copy(g_state)
        gb, cb = batches[i], batches_cpu[i]
        g_grads, g_aux = lane_grads(g_model, g_embed, g_state, *gb, bce)
        c_grads, c_aux = lane_grads(c_model, c_embed, c_state, *cb, bce)
        bounds = {}
        for j, part in enumerate(g_embed.parts):
            key = f"part{j}"
            g_up = sparse_updates(part, g_state.embed[key],
                                  gb[1][:, g_embed._cols[j]], g_grads[key],
                                  g_aux[key], lr)
            c_up = sparse_updates(c_embed.parts[j], c_state.embed[key],
                                  cb[1][:, c_embed._cols[j]], c_grads[key],
                                  c_aux[key], lr)
            for (leaf, rows, upd), (_, _, c_upd) in zip(g_up, c_up):
                table = g_state.embed[key][leaf].reshape(
                    g_state.embed[key][leaf].shape[0], -1)
                keep = (rows >= 0) & (rows < table.shape[0])
                lane_gap = torch.zeros_like(table).index_add_(
                    0, torch.where(keep, rows, 0).long(),
                    (upd - c_upd.cuda()).abs() * keep[:, None])
                # no kept lane (AdaEmbed's first step): nothing may land
                bounds[f"/{key}/{leaf}"] = float(lane_gap.max()) + (
                    2 * reorder_bound(table, rows[keep], upd)
                    if bool(keep.any()) else 0.0)
        g_state, gm = g_step(g_state, *gb)
        c_state, cm = c_step(c_state, *cb)
        for name in gm:
            if name.endswith(("_promotions", "_admitted")) and \
                    int(gm[name]) != int(cm[name]):
                raise AssertionError(f"step {i}: {name} {int(gm[name])} "
                                     f"on the card, {int(cm[name])} on "
                                     f"the CPU")
        worse(rec["max_abs_diff"], "loss",
              abs(float(gm["loss"]) - float(cm["loss"])))
        for path, a, b in _pairs(g_state.embed, c_state.embed):
            if a.dtype.kind in "biu" or path not in bounds:
                if not np.array_equal(a, b):
                    raise AssertionError(f"step {i}: {path} differs "
                                         f"between card and CPU")
                continue
            diff = float(np.abs(a - b).max())
            worse(rec["max_abs_diff"], path, diff)
            worse(rec["max_share_of_bound"], path,
                  diff / bounds[path] if bounds[path] else 0.0)
            if not diff <= bounds[path]:
                raise AssertionError(f"step {i}: {path} differs by {diff} "
                                     f"> its bound {bounds[path]}")
        for f in ("params", "embed_dense"):
            for path, a, b in _pairs(getattr(g_state, f),
                                     getattr(c_state, f)):
                diff = float(np.abs(a - b).max())
                worse(rec["max_abs_diff"], f + path, diff)
                if not diff <= DENSE_TOL:
                    raise AssertionError(f"step {i}: {f}{path} differs by "
                                         f"{diff} > {DENSE_TOL}")
        _, g_aux = g_embed.gather(g_state.embed, gb[1])
        _, c_aux = c_embed.gather(c_state.embed, cb[1])
        for path, a, b in _pairs(g_aux, c_aux):
            if a.dtype.kind in "biu" and not np.array_equal(a, b):
                raise AssertionError(f"step {i}: routed {path} differs "
                                     f"between card and CPU")
    rec.update(integer_state_equal=True, routing_equal=True,
               dense_tolerance=DENSE_TOL, pre_steps=pre_steps,
               plus_fires=fires if any(getattr(p, "plus", False)
                                       for p in g_embed.parts) else None)
    return rec


def method_kernel_cases(name, rowsum, scatter_add, embed, state, batch):
    """K2 and K3 against their plain versions at the shapes a method's
    step gives them: K2 at the sibling QR's q table (its batch's q rows,
    24 lanes moved to n_rows) and AdaEmbed's weight pool (its batch's
    rows, slot-0 lanes at n_rows); K3 at the headline QR's q and r
    tables and Off's table, with the rows they route a batch to (without
    the stage breakdown: late in the run torch.profiler recorded no
    device time; kernels_rowsum has the stages)."""
    if name not in ("qr_sibling", "ada_sibling", "qr_add", "off"):
        return {}
    rng = np.random.default_rng(4)
    _, aux = embed.gather(state.embed, batch[1])
    key = next(f"part{i}" for i, p in enumerate(embed.parts)
               if type(p).__name__ in ("QRPart", "AdaPart", "OffPart"))
    part, st = embed.parts[int(key[4:])], state.embed[key]

    def upd_for(ids, d):
        return torch.from_numpy(rng.normal(
            0, 0.01, (ids.shape[0], d)).astype(np.float32)).cuda()

    if name == "qr_sibling":
        ids = aux[key][0].reshape(-1).to(torch.int32).clone()
        n = st["q"].shape[0]
        ids[torch.from_numpy(rng.choice(ids.shape[0], 24,
                                        replace=False)).cuda()] = n
        return {"scatter_add_q": scatter_add_case(
            scatter_add, st["q"], ids, upd_for(ids, st["q"].shape[1]))}
    if name == "ada_sibling":
        rows = aux[key][1].reshape(-1)
        ids = torch.where(rows > 0, rows, st["weight"].shape[0]).to(
            torch.int32)
        return {"scatter_add_weight": scatter_add_case(
            scatter_add, st["weight"], ids,
            upd_for(ids, st["weight"].shape[1]))}
    if name == "qr_add":
        out = {}
        for leaf, rows in (("q", aux[key][0]), ("r", aux[key][1])):
            ids = rows.reshape(-1).to(torch.int32)
            out[f"rowsum_{leaf}"] = rowsum_case(
                rowsum, st[leaf], ids, upd_for(ids, st[leaf].shape[1]),
                stages=False)
        return out
    ids = aux[key][0].reshape(-1).to(torch.int32)       # off
    return {"rowsum_table": rowsum_case(
        rowsum, st["table"], ids, upd_for(ids, st["table"].shape[1]),
        stages=False)}


def modded_data(CTRArrays, data, batches, mod):
    """`data` and `batches` with every id taken modulo `mod` and the
    vocabularies capped at it, as --max_ind_range makes the loader's."""
    sub = CTRArrays(np.ascontiguousarray(data.sparse % mod), data.dense,
                    data.label, np.minimum(data.counts, mod))
    return sub, [(d, s % mod, l, v) for d, s, l, v in batches]


def phase_cli_methods(main_fn, make_criteo_arrays, kernels, device="cuda"):
    """main_torch.main --compress_method qr --model dcn at the headline
    flags (dense apply) on the CLI_ROWS memmap: 48 graphed steps and 2
    evals, K3 twice a step (q and r) on the card, finite losses."""
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_methods_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        for k in kernels.values():
            k.launches = 0
        res, out = run_cli(main_fn, CLI_FLAGS + [
            "--data_path", root, "--compress_method", "qr", "--model", "dcn",
            "--print_freq", "8", "--test_freq", "24",
            "--tensor_board_filename", ""]
            + (["--force_platform", "cpu"] if device == "cpu" else []),
            "cli_qr_dcn.txt")
        launches = {name: k.launches for name, k in kernels.items()}
        trained = [ln.split() for ln in out
                   if ln.startswith("Finished training it ")]
        losses = [float(w[-1]) for w in trained]
        evals = [ln for ln in out if ln.startswith(" accuracy")]
        if int(trained[-1][3].split("/")[0]) != 48 or not all(
                np.isfinite(losses)) or len(evals) != 2:
            raise AssertionError(f"cli qr+dcn: {trained[-1]}, losses "
                                 f"{losses}, {len(evals)} evals")
        if device == "cuda" and launches != {**{n: 0 for n in kernels},
                                             "rowsum": 96}:
            raise AssertionError(f"cli qr+dcn: launches {launches}")
        return {"rows": CLI_ROWS, "its": 48, "loss_first": losses[0],
                "loss_last": losses[-1], "eval_lines": evals,
                "ms_per_it_median": float(np.median(
                    [float(w[7]) for w in trained])),
                "metrics": res["metrics"], "launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


PLUS_PRE_STEPS = 3            # card steps before the reset's card gate


def plus_configs(Config, cfg128):
    """{name: (config, launches a graph replay must make)} of the CAFE+
    phases: the headline flags (auto and dense apply), the sibling's, and
    the headline with frequency scores and threshold 1, so every placed
    id crosses at once and the reset fires every few steps."""
    plus = dict(cafe_plus=True)
    return {
        "cafe_plus": (headline_cfg(Config, **plus), {"land_max": 0}),
        "cafe_plus_dense": (headline_cfg(Config, sparse_apply_impl="dense",
                                         **plus),
                            {"land_max": 0, "rowsum": 1}),
        "cafe_plus_sibling": (dataclasses.replace(cfg128, **plus),
                              {"land_max": 0, "scatter_add": 1}),
        "cafe_plus_reset": (headline_cfg(Config, cafe_use_freq=True,
                                         cafe_sketch_threshold=1.0, **plus),
                            {"land_max": 0}),
    }


def phase_plus(name, cfg, want, fns, data, batches, batches_cpu, kernels):
    """One CAFE+ configuration: phase_graph (eager and graphed windows,
    the launches a replay makes equal to `want`), how often its reset and
    decay fired in those steps (counted on the card), the replay gate and
    the card-vs-CPU gate (frequency scores; the reset configuration
    keeps its own threshold of 1 and gates from PLUS_PRE_STEPS steps in,
    and must show the reset firing in all three)."""
    (build_all, build_train_step, warmup_calls, fence, clone_state,
     from_reference, to_numpy, bce) = fns
    rec = phase_graph(build_all, build_train_step, warmup_calls, fence, cfg,
                      data, batches, kernels, per_replay_want=want,
                      counter=fire_counter)
    torch.cuda.empty_cache()
    reset = name == "cafe_plus_reset"
    gate_cfg = cfg if reset else dataclasses.replace(
        cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0)
    rec["replay_equals_eager"] = gate_replay(
        build_all, build_train_step, clone_state, from_reference, to_numpy,
        bce, gate_cfg, data, batches,
        exact_tables=cfg.sparse_apply_impl == "dense")
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = gate_card_cpu(
        build_all, from_reference, to_numpy, bce, gate_cfg, data, batches,
        batches_cpu, pre_steps=PLUS_PRE_STEPS if reset else 0)
    torch.cuda.empty_cache()
    if reset:
        seen = {"windows": rec["fires"]["reset"],
                "replay_gate": rec["replay_equals_eager"]["trajectory"][
                    "plus_fires"]["reset"],
                "card_vs_cpu": rec["card_vs_cpu"]["plus_fires"]["reset"]}
        if not all(seen.values()):
            raise AssertionError(f"{name}: the reset did not fire in each "
                                 f"run: {seen}")
    return rec


def phase_plus_reset_cost(build_all, cfg, data, batches, steps=3):
    """The CAFE+ insert at the shape of `cfg` on the sketch state after
    `steps` eager steps, with the first batch's offset ids and scores of
    1: device ms (a call's share of 5 calls captured in one CUDA graph,
    median of 5 replays) of the reset alone, of the insert whose reset
    branch is not taken (real_n pinned below the trip point), of the
    insert that takes it every call (pinned above), and of the insert
    without the reset (adjust_threshold off: no branch)."""
    from cafe_tpu_torch.sketch.hotsketch_plus import (_reset,
                                                      sketch_insert_plus)
    _, embed, state, step, _ = build_all(cfg, data, device="cuda",
                                         capture=False)
    for i in range(steps):
        state, _ = step(state, *batches[i])
    part, key = cafe_key(embed)
    sk, pcfg = state.embed[key]["sketch"], part.sketch_cfg
    oids = part._oids(batches[0][1][:, embed._cols[int(key[4:])]]).reshape(-1)
    ones = torch.ones(oids.shape[0], device=oids.device)
    no_reset = pcfg._replace(adjust_threshold=False)
    cold = {**sk, "real_n": torch.zeros_like(sk["real_n"])}
    hot = {**sk, "real_n": torch.full_like(sk["real_n"],
                                           int(pcfg.lim * 1.2) + 1)}

    def ms(fn):
        return graph_ms(fn, calls=5, reps=5)

    rec = {"lim": pcfg.lim, "n1": pcfg.n1, "n2": pcfg.n2,
           "cells": int(sk["cnt1"].numel() + sk["cnt2"].numel()),
           "lanes": int(oids.shape[0]),
           "reset_ms": ms(lambda: _reset(pcfg, sk)),
           "insert_ms": ms(lambda: sketch_insert_plus(pcfg, cold, oids,
                                                      ones)),
           "insert_reset_fires_ms": ms(lambda: sketch_insert_plus(
               pcfg, hot, oids, ones)),
           "insert_without_reset_ms": ms(
               lambda: sketch_insert_plus(no_reset, cold, oids, ones))}
    rec["reset_share_of_firing_insert"] = \
        rec["reset_ms"] / rec["insert_reset_fires_ms"]
    rec["untaken_branch_overhead"] = \
        rec["insert_ms"] / rec["insert_without_reset_ms"] - 1.0
    del state, sk, cold, hot
    torch.cuda.empty_cache()
    return rec


COND_STEPS = 16               # two inserts at interval 8
COND_GATE_STEPS = 8           # steps from one state, eager against graphed
COND_TIMED = 16               # steps a timed window, each arm
REORDER_TOL = 1e-5            # one step's f32 reordering (float atomics)
COND_ADA_START = 16380        # 4 below a check step and a decay step


def cond_configs(Config):
    """{name: config} of the cond_capture phase: CAFE v1 at the headline
    width (frequency scores, threshold 2, the dense apply: every float
    deterministic) at interval 8 and 2; CAFE+ at cafe_plus_reset's flags
    (its reset fires); hash with Adagrad and with Adam at the headline
    width and cr 0.1 (its 3.4 M-row table takes the per-row optimizer
    arm, which the headline's 34 K rows would not); AdaEmbed at the
    latency grid's width (dim 128, cr 0.1, the CriteoTB towers)."""
    v1 = dict(cafe_use_freq=True, cafe_sketch_threshold=2.0,
              sparse_apply_impl="dense")
    grid = dict(dataset="criteotb", embedding_dim=128, compress_rate=0.1,
                learning_rate=1.0)
    return {
        "cafe_iv8": headline_cfg(Config, cafe_insert_interval=8, **v1),
        "cafe_iv2": headline_cfg(Config, cafe_insert_interval=2, **v1),
        "cafe_plus_reset": headline_cfg(Config, cafe_use_freq=True,
                                        cafe_sketch_threshold=1.0,
                                        cafe_plus=True),
        "hash_adagrad": headline_cfg(Config, compress_method="hash",
                                     optimizer="adagrad", compress_rate=0.1),
        "hash_adam": headline_cfg(Config, compress_method="hash",
                                  optimizer="adam", compress_rate=0.1),
        "ada": headline_cfg(Config, compress_method="ada", **grid),
    }


def _leaf_gaps(a, b):
    """{path: max |a - b| / max(1, max |b|)} of two state trees' float
    leaves, computed on their device (an absolute gap where the leaf's
    values stay under 1, a relative one over accumulated importances
    and counts), and the paths of integer leaves that differ."""
    from cafe_tpu_torch.utils.cond import _leaves
    gaps, bad = {}, []
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if not x.is_floating_point():
            if not torch.equal(x, y):
                bad.append(path)
        elif x.numel():
            gaps[path] = float((x - y).abs().max()
                               / y.abs().max().clamp_min(1.0))
    return gaps, bad


def phase_cond_capture(build_all, build_train_step, clone_state,
                       from_reference, to_numpy, fence, Config, data,
                       batches, kernels):
    """Each configuration of cond_configs from one bridged start state,
    eager and graphed over COND_STEPS steps that take both sides of its
    device branches (utils/cond.cond): every integer leaf bit-equal
    between the two trajectories (their float leaves drift apart where a
    sum runs in float atomics, and the drift is recorded); then
    COND_GATE_STEPS steps each from one state (the graphed state cloned,
    the eager step on the clone): integer leaves bit-equal and float
    leaves within REORDER_TOL, one step's f32 reordering (relative to
    the leaf's largest value where that passes 1). K1's counted launches
    equal the v1 inserts that ran (eager, warm-up spares and replays,
    from branch_runs), every call is replayed but AdaEmbed's check step
    (a host call on the graph's state), CAFE+'s reset is taken inside a
    replay; then COND_TIMED steps each, graphed and eager, ms a step."""
    from cafe_tpu_torch.train.capture import WARMUP_CALLS, branch_runs

    def inserts(runs0):
        runs = branch_runs()
        return {k: runs[k].get("cafe_insert", [0, 0])[1]
                - runs0[k].get("cafe_insert", [0, 0])[1] for k in runs}

    out = {}
    for name, cfg in cond_configs(Config).items():
        gc.collect()
        torch.cuda.empty_cache()
        model, embed, state0, g_step, _ = build_all(cfg, data,
                                                    device="cuda")
        if not g_step.graphed:
            raise AssertionError(f"cond_capture {name}: not graphed: "
                                 f"{g_step.capture_blockers}")
        e_step = build_train_step(model, embed, cfg, capture=False)
        start = to_numpy(state0)
        del state0
        if name == "ada":
            for v in start["embed"].values():
                if "grad_norm" in v:
                    v["step"] = np.asarray(COND_ADA_START, np.int32)
        for k in kernels.values():
            k.launches = 0
        runs0 = branch_runs()
        states, ms = {}, {}
        for mode, step in (("eager", e_step), ("graphed", g_step)):
            st = from_reference(start, "cuda")
            for i in range(COND_STEPS):
                st, m = step(st, *batches[i % len(batches)])
            fence(st, m)
            states[mode] = st
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"cond_capture {name}: loss "
                                     f"{float(m['loss'])}")
        drift, bad = _leaf_gaps(states["eager"], states["graphed"])
        if bad:
            raise AssertionError(f"cond_capture {name}: integer state "
                                 f"differs at {bad}")
        del states["eager"]
        g_st, step_gap = states.pop("graphed"), 0.0
        for i in range(COND_GATE_STEPS):
            b = batches[(COND_STEPS + i) % len(batches)]
            ex, _ = e_step(clone_state(g_st), *b)
            g_st, _ = g_step(g_st, *b)
            gaps, bad = _leaf_gaps(ex, g_st)
            if bad or max(gaps.values()) > REORDER_TOL:
                raise AssertionError(f"cond_capture {name} gate step {i}: "
                                     f"integers {bad}, floats {gaps}")
            step_gap = max(step_gap, max(gaps.values()))
            del ex
        for mode, step in (("graphed", g_step), ("eager", e_step)):
            t0 = time.perf_counter()
            for i in range(COND_TIMED):
                g_st, m = step(g_st, *batches[i % len(batches)])
            fence(g_st, m)
            ms[mode] = (time.perf_counter() - t0) * 1e3 / COND_TIMED
        del g_st
        runs = branch_runs()
        delta = {k: {c: [a - b for a, b in zip(v, runs0[k].get(c, [0, 0]))]
                     for c, v in runs[k].items() if any(v)} for k in runs}
        host = 1 if name == "ada" else 0
        calls = COND_STEPS + COND_GATE_STEPS + COND_TIMED
        if g_step.host_calls != host or g_step.replays != \
                calls - WARMUP_CALLS - host:
            raise AssertionError(f"cond_capture {name}: {g_step.replays} "
                                 f"replays, {g_step.host_calls} host calls")
        ran = inserts(runs0)
        k1 = kernels["land_max"].launches
        is_v1 = name.startswith("cafe_iv")
        if k1 != (sum(ran.values()) if is_v1 else 0):
            raise AssertionError(f"cond_capture {name}: K1 launched {k1}, "
                                 f"v1 inserts ran {ran}")
        # eager inserts: ticks 0 and 8 of the eager trajectory, the
        # graphed run's first warm-up call (tick 0), the gate's eager
        # call at tick 16, the eager window's ticks 40 and 48; its second
        # warm-up call (tick 1) skips and inserts a spare on a clone;
        # replays insert at ticks 8, 16 (gate), 24 and 32 (window)
        if name == "cafe_iv8" and ran != {"eager": 6, "graph": 4,
                                          "spare": 1}:
            raise AssertionError(f"cond_capture {name}: inserts {ran}")
        if name == "cafe_plus_reset" and \
                not delta["graph"].get("plus_reset", [0, 0])[1]:
            raise AssertionError(f"cond_capture {name}: no reset fired in "
                                 f"a replay: {delta}")
        out[name] = {
            "steps": COND_STEPS, "gate_steps": COND_GATE_STEPS,
            "timed_steps": COND_TIMED,
            "eager_ms_per_step": ms["eager"],
            "graphed_ms_per_step": ms["graphed"],
            "speedup": ms["eager"] / ms["graphed"],
            "replays": g_step.replays, "host_calls": g_step.host_calls,
            "capture_s": g_step.capture_s,
            "branch_bodies": len(g_step.branch_launches()),
            "branch_runs": delta, "v1_inserts_ran": ran if is_v1 else None,
            "integer_state_equal": True,
            "trajectory_float_drift": max(drift.values()),
            "gate_max_float_gap": step_gap,
            "launches": {c: k.launches for c, k in kernels.items()}}
        del model, embed, g_step, e_step
    return out


def phase_sketch_bench(bench, kernels):
    """tools/sketch_bench_torch.py in this process on a 60,000-id Zipf
    stream (tests/test_sketch_plus.py's recall case: vocabulary 4,000,
    s 1.2, lim 512, threshold 8, batches of 512): CAFE+ recall must clear
    that test's bound of 0.6. Its prints go to OUT_DIR."""
    for kern in kernels.values():
        kern.launches = 0
    with tool_log("sketch_bench"):
        out = bench.main(["--stream_len", "60000", "--vocab", "4000",
                          "--zipf", "1.2", "--buckets", "512",
                          "--threshold", "8", "--batch", "512",
                          "--cells", "4", "--device", "cuda"])
    recall = out["recall_plus"]["cells4"]["recall"]
    if not recall > 0.6:
        raise AssertionError(f"sketch_bench: CAFE+ recall {recall} <= 0.6")
    return {**{k: out[k] for k in ("recall", "recall_plus", "throughput",
                                   "drift", "device")},
            "launches": {name: k.launches for name, k in kernels.items()}}


QUANT_BITS = (8, 4)
QUANT_GAP = 0.01              # the JAX tests' bound on |p_f32 - p_q8|
# on the largest |p_f32 - p_q| of a CLI serving run, by bits: about 3x
# (int8) and 2x (int4) the largest of cli, cli_plus and cli_sharded on an
# H100 (6.0e-4, 3.4e-3), below what a 10 % scale error gives (8.5e-3,
# 1.2e-2 at the cli run's shape on the CPU)
QUANT_MAX = {8: 0.002, 4: 0.007}


@contextlib.contextmanager
def served_scores():
    """The scores main_torch's evaluations hand to their metrics, one
    array an evaluation, recorded by wrapping the loop's binary_metrics."""
    from cafe_tpu_torch.train import loop
    got, metrics = [], loop.binary_metrics

    def recording(y, p):
        got.append(np.asarray(p, dtype=np.float64))
        return metrics(y, p)

    loop.binary_metrics = recording
    try:
        yield got
    finally:
        loop.binary_metrics = metrics


def serve_cli(main_fn, argv, log_name):
    """run_cli of an --inference_only run: (result, its scores)."""
    with served_scores() as got:
        res, _ = run_cli(main_fn, argv, log_name)
    if len(got) != 1:
        raise AssertionError(f"{log_name}: {len(got)} evaluations, not 1")
    return res, got[0]


def score_gate(name, bits, p_f32, p_q):
    """mean and max |p_f32 - p_q| of one serving run at `bits`, failing
    past QUANT_GAP (mean) or QUANT_MAX[bits] (max)."""
    d = np.abs(p_q - p_f32)
    rec = {"mean_abs_diff": float(d.mean()), "max_abs_diff": float(d.max()),
           "f32_score_std": float(p_f32.std()), "lanes": int(d.size)}
    if d.shape != p_f32.shape or not (rec["mean_abs_diff"] < QUANT_GAP
                                      and rec["max_abs_diff"]
                                      < QUANT_MAX[bits]):
        raise AssertionError(f"{name}: |p_f32 - p_q| {rec}")
    return rec


def _code_values(codes, bits):
    """The codes of a QuantizedTable's code bytes as int16, one a dim."""
    c = codes.to(torch.int16)
    return c if bits == 8 else torch.cat([c & 0x0F, c >> 4], dim=1)


def phase_quant_parity(quantize_rowwise, dequantize_rows, tables):
    """Each table (name -> f32 tensor on the card) quantized on the card
    and on the CPU at 8 and 4 bits: the codes byte-equal (a code one level
    apart, where the card's division rounded a tie the other way, is
    counted; one further apart fails), every scale and zero byte equal;
    the card's codes dequantized on the card and on the CPU at up to
    SERVING_LANES row ids from a seed: bit-equal; the card's quantize
    time."""
    g = torch.Generator().manual_seed(12)
    out = {}
    for name, table in tables.items():
        cpu_table = table.cpu()
        for bits in QUANT_BITS:
            card = quantize_rowwise(table, bits)
            cpu = quantize_rowwise(cpu_table, bits)
            cw = card.codes.shape[1] - 8
            gap = (_code_values(card.codes[:, :cw].cpu(), bits)
                   - _code_values(cpu.codes[:, :cw], bits)).abs()
            one, more = int((gap == 1).sum()), int((gap > 1).sum())
            tail = torch.equal(card.codes[:, cw:].cpu(), cpu.codes[:, cw:])
            idx = torch.randint(0, table.shape[0],
                                (min(SERVING_LANES, table.shape[0]),),
                                generator=g)
            host = card._replace(codes=card.codes.cpu(),
                                 scale=card.scale.cpu(), zero=card.zero.cpu())
            deq = torch.equal(dequantize_rows(card, idx.cuda()).cpu(),
                              dequantize_rows(host, idx))
            if more or not tail or not deq:
                raise AssertionError(
                    f"quant_parity {name} int{bits}: {more} codes more than "
                    f"one level apart; scale and zero bytes equal: {tail}; "
                    f"card's dequantized rows equal the CPU's: {deq}")
            out[f"{name}_int{bits}"] = {
                "table_shape": list(table.shape),
                "codes_shape": list(card.codes.shape),
                "codes_bytes": card.codes.numel(),
                "f32_bytes": table.numel() * 4,
                "byte_equal": one == 0, "codes_one_level_apart": one,
                "dequantized_rows": idx.numel(), "dequantize_equal": deq,
                "quantize_ms": time_ms(lambda: quantize_rowwise(table, bits),
                                       reps=5, warmup=1)}
            del card, cpu, host
    return out


SERVING_ARGS = {
    "headline": ["--dataset", "criteo", "--dim", "16", "--compress_rate",
                 "0.001", "--learning_rate", "0.1", "--test_batch", "2048"],
    "serving": [],          # the tool's own: dim 128, cr 0.1, 16,384 rows
}


SERVING_LANES = 425984        # 16,384 rows x 26 fields
SIBLING_ROWS = 3232256


def row_gather_ab(windows=5, reps=20):
    """The code-row gather of ops/quantized.dequantize_rows in its two
    forms at the serving shape: rows of 136 B (int8, dim 128) and 72 B
    (int4) of a SIBLING_ROWS-row table, SERVING_LANES uniform row ids
    from a seed. "bytes" gathers the uint8 rows (codes[idx]), "words"
    gathers them as int32 words (codes.view(int32)[idx]); the same bytes
    come back (checked). Median ms of alternating windows, and the bound
    (rows read and written once, the ids read once, over
    HBM_BYTES_PER_S)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, width in (("int8", 136), ("int4", 72)):
        codes = torch.randint(0, 256, (SIBLING_ROWS, width),
                              dtype=torch.uint8, device="cuda", generator=g)
        idx = torch.randint(0, SIBLING_ROWS, (SERVING_LANES,),
                            device="cuda", generator=g)
        arms = {"bytes": lambda: codes[idx],
                "words": lambda: codes.view(torch.int32)[idx]}
        if not torch.equal(arms["words"]().view(torch.uint8),
                           arms["bytes"]()):
            raise AssertionError(f"row_gather {name}: the forms differ")
        ms = {arm: [] for arm in arms}
        for w in range(windows):
            order = ("bytes", "words") if w % 2 == 0 else ("words", "bytes")
            for arm in order:
                ms[arm].append(time_ms(arms[arm], reps=reps))
        moved = SERVING_LANES * (2 * width + 8)
        out[name] = {"row_bytes": width,
                     **{f"{arm}_ms": float(np.median(v))
                        for arm, v in ms.items()},
                     "windows": ms, "bound_ms": bound_ms(moved, 0)[0]}
        del codes, idx
    return out


def phase_serving_quant(bench, windows=5, steps=20):
    """tools/serving_bench_torch.py in this process at the headline shape
    (B = 2048) and at its own serving shape (16,384 rows): graphed ms a
    call of f32, int8 and int4 in alternating windows, the codes' bytes
    against the f32 table, and mean |p_f32 - p_q| < QUANT_GAP; each
    arm's device time a call and top kernels under torch.profiler."""
    out = {}
    for name, argv in SERVING_ARGS.items():
        with tool_log(f"serving_bench_{name}"):
            rec = bench.main(argv + ["--windows", str(windows), "--steps",
                                     str(steps), "--device", "cuda"])
        if not all(rec["graphed"].values()):
            raise AssertionError(f"serving_quant {name}: {rec['graphed']}")
        if not max(rec["mean_abs_diff"].values()) < QUANT_GAP:
            raise AssertionError(f"serving_quant {name}: mean |p_f32 - "
                                 f"p_q| {rec['mean_abs_diff']}")
        rec["vs_fp32"] = {arm: rec[f"{arm}_ms"] / rec["fp32_ms"]
                          for arm in ("int8", "int4")}
        out[name] = rec
        torch.cuda.empty_cache()
    out["row_gather"] = row_gather_ab()
    torch.cuda.empty_cache()
    return out


def four_gathers(cfg, sk, ids):
    """The v1 sketch query as four narrow row gathers of val, cnt and
    dic (query_cells' form before the packed one), for the A/B."""
    from cafe_tpu_torch.sketch.hotsketch import _bucket_of
    h = _bucket_of(cfg, ids).long()
    val, cnt, dic = sk["val"], sk["cnt"], sk["dic"]
    m = (cnt[h] > 0) & (val[h] == ids[:, None]) & (dic[h] != 0)
    slot = torch.where(m, dic[h], 0).amax(dim=1)
    return torch.where(slot > 0, -slot, ids)


def phase_serving_packed(build_all, quant_eval, Config, data, batches,
                         serving, warmup_calls):
    """CAFE v1's packed sketch view, frozen at quantize time
    (CafePart.quantize_for_serving), on the card at the headline flags
    with frequency scores and threshold 2 after 8 graphed steps, so ids
    route hot:

    * route: query_cells_packed on the view equals the plain query
      (sketch_query) exactly for every batch's ids, hot lanes among them;
    * rows: gather_quantized through the view bit-equal to the plain
      route's (the view taken out of the tables), at 8 and 4 bits;
    * scores: the graphed int8 eval step through the view bit-equal to
      the graphed one without it, on every batch;
    * the query alone at the headline step's lanes: four narrow row
      gathers (four_gathers, query_cells' form before the packed one)
      against packing and querying each call (query_cells) and against
      the frozen view (time_ms); `packed_form_wins` records the A/B
      that moved query_cells to the packed form;
    * serving_quant's A/B (tools/serving_bench_torch.py: its int8 arm
      through the view against its int8_plain arm, in alternating
      windows of one call) at B = 2048 and at 16,384 rows, the latency
      protocol's eval configuration."""
    from cafe_tpu_torch.sketch.hotsketch import (_pack_cells,
                                                 query_cells_packed,
                                                 sketch_query)
    cfg = headline_cfg(Config, cafe_use_freq=True, cafe_sketch_threshold=2.0)
    model, embed, state, step, _ = build_all(cfg, data, device="cuda")
    for i in range(8):
        state, m = step(state, *batches[i % len(batches)])
    torch.cuda.synchronize()
    part, key = cafe_key(embed)
    cols = embed._cols[int(key[4:])]
    st = state.embed[key]
    sk, scfg = st["sketch"], part.sketch_cfg
    packed = _pack_cells(sk["val"], sk["cnt"], sk["dic"])
    hot = 0
    for b in batches:
        oids = part._oids(b[1][:, cols]).reshape(-1)
        plain = sketch_query(scfg, sk, oids)
        if not torch.equal(query_cells_packed(scfg, packed, oids), plain):
            raise AssertionError("serving_packed: the packed query differs "
                                 "from the plain one")
        hot += int((plain < 0).sum())
    if not hot:
        raise AssertionError("serving_packed: no lane routed hot")
    for bits in QUANT_BITS:
        qt = part.quantize_for_serving(st, bits)
        if "sk_packed" not in qt or not torch.equal(qt["sk_packed"],
                                                    packed):
            raise AssertionError(f"serving_packed: no frozen view at "
                                 f"{bits} bits")
        plain_qt = {k: v for k, v in qt.items() if k != "sk_packed"}
        for b in batches:
            if not torch.equal(part.gather_quantized(st, qt, b[1][:, cols]),
                               part.gather_quantized(st, plain_qt,
                                                     b[1][:, cols])):
                raise AssertionError(f"serving_packed: rows through the "
                                     f"view differ at {bits} bits")
    view = quant_eval(model, embed, state, 8)
    plain_step = quant_eval(model, embed, state, 8)
    for q in plain_step.qtables.values():
        q.pop("sk_packed", None)
    calls = warmup_calls + 1 + len(batches)
    for i in range(calls):
        d, ids = batches[i % len(batches)][:2]
        if not torch.equal(view(state, d, ids).clone(),
                           plain_step(state, d, ids)):
            raise AssertionError(f"serving_packed: int8 scores through the "
                                 f"view differ, call {i}")
    if not (view.graphed and plain_step.graphed):
        raise AssertionError("serving_packed: a quantized step not graphed")
    oids = part._oids(batches[0][1][:, cols]).reshape(-1)
    if not torch.equal(four_gathers(scfg, sk, oids),
                       sketch_query(scfg, sk, oids)):
        raise AssertionError("serving_packed: four gathers differ")
    query = {
        "lanes": int(oids.numel()), "buckets": int(sk["val"].shape[0]),
        "four_gathers_ms": time_ms(lambda: four_gathers(scfg, sk, oids)),
        "pack_ms": time_ms(lambda: _pack_cells(sk["val"], sk["cnt"],
                                               sk["dic"])),
        "pack_and_query_ms": time_ms(lambda: sketch_query(scfg, sk, oids)),
        "frozen_view_ms": time_ms(lambda: query_cells_packed(scfg, packed,
                                                             oids))}
    query["packed_form_wins"] = \
        query["pack_and_query_ms"] < query["four_gathers_ms"]
    ab = {name: {"test_batch": r["test_batch"], "view_ms": r["int8_ms"],
                 "plain_ms": r["int8_plain_ms"],
                 "view_over_plain": r["int8_ms"] / r["int8_plain_ms"],
                 "view_bytes": r["view_bytes"],
                 "routes_equal": r["routes_equal"],
                 "windows": {a: r["windows"][a]
                             for a in ("int8", "int8_plain")}}
          for name, r in serving.items() if name in SERVING_ARGS}
    del view, plain_step, state, embed, model, step
    torch.cuda.empty_cache()
    return {"hot_lanes": hot, "route_equal": True, "rows_equal": True,
            "scores_bit_equal": True, "score_calls": calls,
            "query": query, "ab": ab}


def phase_sharded_quant(build_all, init_state, copy_into, quant_eval, cfg,
                        data, batches, mesh):
    """The quantized eval step on a mesh of one rank, graphed and eager,
    against the same state served on one device through
    enable_sharded_layout(1) (graphed): scores bit-equal at 8 and 4 bits
    on every batch; ms a call of each."""
    model, embed, state, step, _ = build_all(cfg, data, mesh=mesh,
                                             capture=False)
    for b in batches[:3]:
        state, _ = step(state, *b)
    one = dataclasses.replace(cfg, mesh_shape=None, shard_embeddings=False)
    model1, embed1, _, _, _ = build_all(one, data, capture=False)
    layout = [p.enable_sharded_layout(1) for p in embed1.parts
              if type(p).__name__ == "CafePart"]
    if not layout or not all(layout):
        raise AssertionError(f"sharded_quant: layouts {layout}")
    state1 = init_state(model1, embed1, one.numpy_rand_seed, one.optimizer)
    copy_into(state1, state)
    out = {"plus": cfg.cafe_plus}
    for bits in QUANT_BITS:
        qm = quant_eval(model, embed, state, bits)
        qe = quant_eval(model, embed, state, bits, capture=False)
        q1 = quant_eval(model1, embed1, state1, bits)
        if not (qm.graphed and q1.graphed) or qe.graphed:
            raise AssertionError("sharded_quant: the mesh step must be "
                                 "graphed and eager, the single-device one "
                                 "graphed")
        for i in range(2 * len(batches)):
            d, s = batches[i % len(batches)][:2]
            got = qm(state, d, s).clone()
            if not (torch.equal(got, qe(state, d, s))
                    and torch.equal(got, q1(state1, d, s))):
                raise AssertionError(f"sharded_quant int{bits}: batch {i} "
                                     f"scores differ")
        d, s = batches[0][:2]
        out[f"int{bits}"] = {
            "bit_equal_batches": 2 * len(batches),
            "mesh_graphed_ms": time_ms(lambda: qm(state, d, s), reps=10),
            "mesh_eager_ms": time_ms(lambda: qe(state, d, s), reps=10),
            "single_graphed_ms": time_ms(lambda: q1(state1, d, s), reps=10)}
    return out


def phase_export(build_all, export_eval_step, cfg, data, batches,
                 tol=1e-5):
    """The headline eval exported from the card's state at B = 2048
    (cafe_tpu_torch/tools/export_model.py), loaded back and held against
    the eager eval step on every batch within `tol`; the export and load
    seconds, the file's bytes and ms a call of each."""
    model, embed, state, step, ev = build_all(cfg, data, capture=False)
    for b in batches[:3]:
        state, _ = step(state, *b)
    root = tempfile.mkdtemp(prefix="chip_smoke_export_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        path = os.path.join(root, "headline.pt2")
        t0 = time.perf_counter()
        n = export_eval_step(model, embed, state, cfg.mini_batch_size,
                             data.num_dense, data.num_sparse, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = torch.export.load(path).module()
        load_s = time.perf_counter() - t0
        err = 0.0
        with torch.no_grad():
            for d, s, _, _ in batches:
                err = max(err, float((served(d, s) - ev(state, d, s))
                                     .abs().max()))
            if not err <= tol:
                raise AssertionError(f"export: max |served - eager| {err}")
            d, s = batches[0][:2]
            return {"batch": cfg.mini_batch_size, "bytes": n,
                    "export_s": export_s, "load_s": load_s,
                    "max_abs_err": err, "tolerance": tol,
                    "batches": len(batches),
                    "served_ms": time_ms(lambda: served(d, s), reps=10),
                    "eager_ms": time_ms(lambda: ev(state, d, s), reps=10)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the data and experiment tools

PREPROCESS_ROWS = 131072      # 112,347 train rows (55 its), 18,725 test
GRID_ROWS = 262144            # criteo_grid: 224,694 train rows, 109 steps
GRID_GATE_STEPS = 8           # card against CPU, each step from one state
INTERACTIONS = dict(users=2000, items=1000, events=60000, leave_n=1)


def write_kaggle_tsv(path, rows, seed=0):
    """A Kaggle-format raw TSV: label, 13 integer dense cells (10 %
    missing), 26 categoricals of 8 hex digits (5 % missing) drawn with
    make_criteo_arrays' skew over the 26 Kaggle vocabularies, so CAFE at
    cr 1e-3 keeps a sketch (tests/test_preprocess_parity.py's fixture has
    the same format at vocabularies of at most 1,000)."""
    from cafe_tpu_torch.data import CRITEO_COUNTS
    rng = np.random.default_rng(seed)
    ints = np.array([""] + [str(v) for v in range(-2, 1000)])
    label = rng.integers(0, 2, rows)
    dense = np.where(rng.random((rows, 13)) < 0.1, 0,
                     rng.integers(1, 1003, (rows, 13)))
    cols = [ints[label + 3][:, None], ints[dense]]
    for n in CRITEO_COUNTS:
        ids = ((rng.random(rows) ** 4.0 * n).astype(np.int64)
               * 1000000007) % n
        uniq, inv = np.unique(ids, return_inverse=True)
        text = np.array([""] + [f"{v:08x}" for v in uniq.tolist()])
        cols.append(np.where(rng.random(rows) < 0.05, "",
                             text[inv + 1])[:, None])
    table = np.concatenate(cols, axis=1)
    with open(path, "w") as f:
        f.write("\n".join(map("\t".join, table.tolist())) + "\n")


def first_seen_relabel(native_ids, sorted_ids):
    """True when each field's native ids are 0, 1, 2, ... in order of
    first appearance and map one to one onto the sorted encoder's ids
    (native/encoder.cpp numbers tokens as it meets them; the Python
    encoder sorts them, as sklearn's LabelEncoder does)."""
    for j in range(sorted_ids.shape[1]):
        nat, ref = native_ids[:, j], sorted_ids[:, j]
        first = np.unique(nat, return_index=True)[1]
        if not (np.array_equal(np.sort(first), first)
                and np.array_equal(ref, ref[first][nat])
                and len(np.unique(ref)) == len(first)):
            return False
    return True


def phase_preprocess_cli(main_fn, preprocess, native, kernels, root,
                         device="cuda"):
    """A 131,072-row Kaggle-format TSV through the port's preprocess (the
    Python encoder) and native.NativeEncoder into `root`/py and
    `root`/native: counts, labels and dense floats byte-equal, sparse ids
    equal up to each field's first-seen relabelling. Then main_torch.main
    trains one epoch on the preprocessed memmap (CAFE, cr 1e-3, the dense
    apply) and evaluates: K1 and K3 once an iteration, a finite AUC."""
    raw = os.path.join(root, "train.txt")
    t0 = time.perf_counter()
    write_kaggle_tsv(raw, PREPROCESS_ROWS)
    rec = {"rows": PREPROCESS_ROWS, "raw_bytes": os.path.getsize(raw),
           "write_s": time.perf_counter() - t0}

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    def native_encode():
        enc = native.NativeEncoder(num_dense=13, num_sparse=26, sep="\t")
        enc.collect(raw)
        enc.encode(raw, os.path.join(root, "native"))

    # one after the other, so that each time is that encoder's own
    rec["python_encoder_s"] = timed(preprocess.process_criteo, raw,
                                    os.path.join(root, "py"))
    rec["native_encoder_s"] = timed(native_encode)
    files = {}
    for name in ("count", "label", "dense", "sparse_sep"):
        files[name] = [open(os.path.join(root, d, f"processed_{name}.bin"),
                            "rb").read() for d in ("py", "native")]
    for name in ("count", "label", "dense"):
        if files[name][0] != files[name][1]:
            raise AssertionError(f"preprocess: processed_{name}.bin differs "
                                 f"between the Python and native encoders")
    py_ids, nat_ids = (np.frombuffer(b, np.int32).reshape(-1, 26)
                       for b in files["sparse_sep"])
    if not first_seen_relabel(nat_ids, py_ids):
        raise AssertionError("preprocess: native sparse ids are not the "
                             "Python ids relabelled in first-seen order")
    rec["counts"] = np.frombuffer(files["count"][0], np.int32).tolist()
    rec["bytes_equal"] = ["count", "label", "dense"]
    rec["sparse_first_seen_relabel"] = True
    os.remove(raw)

    plat = ["--force_platform", "cpu"] if device == "cpu" else []
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res, lines = run_cli(main_fn, CLI_FLAGS + plat + [
        "--data_path", os.path.join(root, "py"), "--nepochs", "1",
        "--print_freq", "16", "--test_freq", "100000",
        "--tensor_board_filename", os.path.join(root, "tb")],
        "preprocess_cli_run.txt")
    rec["train_wall_s"] = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    trained = [ln.split() for ln in lines
               if ln.startswith("Finished training it ")]
    its = int(trained[-1][3].split("/")[1])
    auc = res["metrics"]["roc_auc"]
    if int(trained[-1][3].split("/")[0]) != its or not np.isfinite(auc):
        raise AssertionError(f"preprocess_cli: {trained[-1]}, {res}")
    if device == "cuda" and (launches["land_max"] != its
                             or launches["rowsum"] != its):
        raise AssertionError(f"preprocess_cli: launches {launches} in "
                             f"{its} its")
    rec.update(its=its, metrics=res["metrics"], launches=launches,
               ms_per_it_median=float(np.median([float(w[7])
                                                 for w in trained])))
    return rec


def phase_job_scheduler(job_scheduler, visualization, data_path, root,
                        cpu=False):
    """A task file whose `base` points at the preprocessed data, with a
    hash section (cr 1e-3) and a CAFE section pairing two compress rates
    with two thresholds: 3 tasks through job_scheduler.schedule (3
    workers; main_torch.py processes on the card). Every return code 0,
    each run directory holds config.json, stdouterr.log and
    scalars.jsonl, and visualization reads an AUC back for each run."""
    board = os.path.join(root, "board")
    base = {CLI_FLAGS[i][2:]: CLI_FLAGS[i + 1]
            for i in range(0, len(CLI_FLAGS), 2)}
    base.update(data_path=data_path, nepochs=1, print_freq=32,
                test_freq=100000)
    spec = {"base": base,
            "hash": {"compress_method": "hash", "compress_rate": [0.001],
                     "tensor_board_filename": os.path.join(board, "hash")},
            "cafe": {"compress_method": "cafe",
                     "compress_rate": [0.01, 0.001],
                     "cafe_sketch_threshold": [100, 500],
                     "tensor_board_filename": os.path.join(board, "cafe")}}
    path = os.path.join(root, "tasks.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    with tool_log("job_scheduler"):
        codes = job_scheduler.schedule([path], workers=3, cpu=cpu)
    rec = {"tasks": len(codes), "return_codes": codes,
           "wall_s": time.perf_counter() - t0, "runs": {}}
    if codes != [0, 0, 0]:
        raise AssertionError(f"job_scheduler: return codes {codes}")
    for method, crs in (("hash", [0.001]), ("cafe", [0.01, 0.001])):
        runs = visualization.collect_method_runs(board, method)
        if sorted(runs) != sorted(crs):
            raise AssertionError(f"job_scheduler: {method} runs {runs}")
        for cr in crs:
            run = os.path.join(board, f"{method}{cr}")
            for name in ("config.json", "stdouterr.log", "scalars.jsonl"):
                if not os.path.exists(os.path.join(run, name)):
                    raise AssertionError(f"job_scheduler: {run} has no "
                                         f"{name}")
            if not np.isfinite(runs[cr].get("auc", np.nan)):
                raise AssertionError(f"job_scheduler: {run}: {runs[cr]}")
            rec["runs"][f"{method}{cr}"] = runs[cr]
    return rec


def grid_batches(train, n, device):
    """The first `n` grid batches (drop_last) on `device`."""
    from cafe_tpu_torch.data import batch_iterator
    out = []
    for dense, sparse, label, valid in itertools.islice(
            batch_iterator(train, 2048, drop_last=True), n):
        out.append((*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                      for x in (dense, sparse, label)), valid))
    return out


def phase_criteo_grid(criteo_grid, build_all, from_reference, to_numpy, bce,
                      land, kernels, out_path, device="cuda"):
    """cafe_tpu_torch.tools.criteo_grid.main on 262,144 rows of the
    Criteo-scale stream (the 26 Kaggle vocabularies), one epoch: full,
    hash and CAFE at cr 1e-3, then CAFE at cr 0.1 (K1's largest bucket
    count), into a fresh `out_path`. Gates: 4 records of 109 steps each,
    0.5 < AUC <= 1, slots_used <= slot_capacity (CAFE at cr 1e-3 must
    report them), K1 109 times a CAFE config; the first call again writes
    nothing and skips each record. Then card against CPU for hash and CAFE
    (frequency scores) at cr 1e-3 over GRID_GATE_STEPS steps, each from
    one state (gate_card_cpu), and K1 on the inputs the 17th eager step of
    CAFE at cr 0.1 gives it, timed (land_real_case)."""
    if os.path.exists(out_path):
        os.remove(out_path)
    plat = ["--platform", "cpu"] if device == "cpu" else []
    base = ["--rows", str(GRID_ROWS), "--epochs", "1", "--out", out_path]
    first = base + plat + ["--methods", "full", "hash", "cafe", "--crs",
                           "0.001"]
    calls = {}
    for name, argv in (("a", first), ("b", base + plat + [
            "--methods", "cafe", "--crs", "0.1"]), ("again", first)):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        try:
            _, lines = run_cli(criteo_grid.main, argv,
                               f"tools_criteo_grid_{name}.txt")
        except SystemExit as e:
            raise AssertionError(f"criteo_grid {name}: exit {e.code}")
        calls[name] = {"wall_s": time.perf_counter() - t0, "lines": lines,
                       "launches": {n: k.launches
                                    for n, k in kernels.items()}}
    with open(out_path) as f:
        recs = [json.loads(ln) for ln in f]
    keys = [(r["method"], r["cr"]) for r in recs]
    if keys != [("full", 1.0), ("hash", 0.001), ("cafe", 0.001),
                ("cafe", 0.1)]:
        raise AssertionError(f"criteo_grid: records {keys}")
    steps = GRID_ROWS * 6 // 7 // 2048
    for r in recs:
        if r["steps"] != steps or not 0.5 < r["auc"] <= 1.0:
            raise AssertionError(f"criteo_grid: {r}")
        if r.get("slots_used", 0) > r.get("slot_capacity", 0):
            raise AssertionError(f"criteo_grid: slots {r}")
    if "slots_used" not in recs[2]:
        raise AssertionError(f"criteo_grid: CAFE at cr 1e-3 reports no "
                             f"slots: {recs[2]}")
    skips = [ln for ln in calls["again"]["lines"] if ln.startswith("skip")]
    if len(skips) != 3 or any("--- " in ln
                              for ln in calls["again"]["lines"]):
        raise AssertionError(f"criteo_grid again: {calls['again']['lines']}")
    if device == "cuda" and (calls["a"]["launches"]["land_max"] != steps
                             or calls["b"]["launches"]["land_max"]
                             != steps):
        raise AssertionError(f"criteo_grid: K1 launches "
                             f"{calls['a']['launches']}, "
                             f"{calls['b']['launches']}, not {steps} a "
                             f"CAFE config")
    rec = {"records": recs, "skipped_again": skips,
           "wall_s": {n: c["wall_s"] for n, c in calls.items()},
           "launches": {n: calls["a"]["launches"][n]
                        + calls["b"]["launches"][n] for n in kernels}}

    data = criteo_grid.gen_data(GRID_ROWS, 1.1, 7)
    cut = GRID_ROWS * 6 // 7
    train = type(data)(data.sparse[:cut], data.dense[:cut],
                       data.label[:cut], data.counts)
    gb = grid_batches(train, GRID_GATE_STEPS + 1, device)
    gb_cpu = [(d.cpu(), s.cpu(), l.cpu(), v) for d, s, l, v in gb]
    rec["card_vs_cpu"] = {}
    for method in ("hash", "cafe"):
        cfg = criteo_grid.grid_config(method, 0.001, 500.0, 0.2, GRID_ROWS,
                                      2048, cafe_use_freq=True)
        rec["card_vs_cpu"][method] = gate_card_cpu(
            build_all, from_reference, to_numpy, bce, cfg, train, gb,
            gb_cpu, steps=GRID_GATE_STEPS)
        if device == "cuda":
            torch.cuda.empty_cache()
    cfg = criteo_grid.grid_config("cafe", 0.1, 20.0, 0.5, GRID_ROWS, 2048)
    _, _, state, step, _ = build_all(cfg, train, device=device,
                                     capture=False)
    for b in gb[:GRID_GATE_STEPS]:
        state, _ = step(state, *b)
    k1 = land_captured(land, lambda: step(state, *gb[GRID_GATE_STEPS]))
    rec["land_max_case_cr0.1"] = land_real_case(land, *k1[0])
    del state, step
    return rec


def write_events(path, users, items, events, seed=0):
    """A (user, item, timestamp) CSV: Zipf-skewed items, each user's
    events spread over a year of zero-padded epoch seconds."""
    rng = np.random.default_rng(seed)
    user = rng.integers(0, users, events)
    item = np.minimum((rng.random(events) ** 2 * items).astype(np.int64),
                      items - 1)
    ts = rng.integers(1_600_000_000, 1_631_536_000, events)
    with open(path, "w") as f:
        f.write("user_id,item_id,created_at\n")
        f.writelines(f"u{u},t{i},{t:012d}\n"
                     for u, i, t in zip(user.tolist(), item.tolist(),
                                        ts.tolist()))


def phase_graphrec_interactions(gr, process_interactions, kernels, root,
                                device="cuda"):
    """An events CSV (2,000 users x 1,000 items, 60,000 events) split by
    process_interactions (the last event of each user held out), then
    LightGCN with CAFE for one epoch through main_graphrec_torch.main
    --data_path on the split: leave_n test items a user, K1 once a step,
    a finite recall@20."""
    csv_path = os.path.join(root, "events.csv")
    split = os.path.join(root, "split")
    write_events(csv_path, INTERACTIONS["users"], INTERACTIONS["items"],
                 INTERACTIONS["events"])
    stats = process_interactions.process(
        csv_path, split, "user_id", "item_id", "created_at",
        INTERACTIONS["leave_n"])
    with open(os.path.join(split, "test.txt")) as f:
        held = [len(ln.split()) - 1 for ln in f]
    if stats["users"] != INTERACTIONS["users"] or \
            set(held) != {INTERACTIONS["leave_n"]}:
        raise AssertionError(f"process_interactions: {stats}, held-out "
                             f"counts {sorted(set(held))}")
    plat = ["--force_platform", "cpu"] if device == "cpu" else []
    flags = LIGHTGCN_FLAGS[:LIGHTGCN_FLAGS.index("--synthetic_users")]
    res, lines, wall, launches = graphrec_cli(
        gr.main, flags + plat + ["--data_path", split, "--epochs", "1",
                                 "--sketch_threshold", LIGHTGCN_THRESHOLD],
        "graphrec_interactions.txt", kernels)
    k1 = launches["land_max"]
    ep = res["epochs"][-1]
    if not (np.isfinite(ep["loss"]) and np.isfinite(ep["recall"])):
        raise AssertionError(f"graphrec_interactions: {res}")
    if device == "cuda" and k1 != ep["steps"]:
        raise AssertionError(f"graphrec_interactions: K1 launched {k1} "
                             f"times in {ep['steps']} steps")
    return {"split": stats, **ep, "wall_s": wall, "launches": launches,
            "launches_in_graphs": res["launches_in_graphs"],
            "capture": graphrec_graph_gate("graphrec_interactions", res,
                                           device),
            "lines": [ln for ln in lines if ln.startswith("epoch")]}


# ---------------------------------------------------------------------------
# The repo's root measurement tools (tools/*_torch.py) and the dataset
# launcher, each in this process at the shapes its JAX twin uses (module
# docstring, phases 52-63); their own prints go to OUT_DIR/tools_*.txt.

TOOL_WINDOWS, TOOL_STEPS = 2, 20
BREAKDOWN_WARMUP = 5          # a graphed arm captures on its third call
LATENCY_KEYS = {"method", "dim", "cr", "train_ms_per_it", "test_ms_per_it",
                "train_batch", "test_batch", "examples_per_s", "windows",
                "build_s", "table_rows"}     # tools/latency_grid.py:99-108
RESET_KEYS = {"lim", "batch", "candidate_cells", "steady_us",
              "steady_minmax", "forced_reset_us", "forced_minmax",
              "per_fire_us", "worst_case_min_steps_between_fires",
              "worst_case_amortized_overhead", "zipf_stream_steps",
              "zipf_stream_fires"}            # tools/reset_cost.py:112-126
OVERHEAD_KEYS = {"shape", "us_k16", "us_k128", "us_per_kernel",
                 "bandwidth_us_expected"}   # kernel_overhead_probe.py:56-61
SWEEP_POINTS = 2
LAUNCHER_FLAGS = ["--compress_method", "cafe", "--compress_rate", "0.001",
                  "--cafe_sketch_threshold", "500", "--cafe_hash_rate", "0.5",
                  "--sparse_apply_impl", "dense", "--bf16", "true",
                  "--mini_batch_size", "1024", "--test_freq", "1000000"]


def _zero(kernels):
    for k in kernels.values():
        k.launches = 0


def _counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


def positive(name, readings):
    """Fail on a reading that is not finite and above 0."""
    bad = {k: v for k, v in readings.items()
           if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"{name}: non-finite or non-positive readings "
                             f"{bad}")


def lands(table, ids, upd) -> bool:
    """Whether a K2 call adds any lane (AdaEmbed's first steps send every
    lane to the dropped row n_rows)."""
    return bool(((ids >= 0) & (ids < table.shape[0])).any())


@contextlib.contextmanager
def first_inputs(module, attr, keep=1, wanted=None, by_ref=0):
    """Record the arguments of `module.attr`'s first calls made outside a
    CUDA graph capture (and, given `wanted`, for which wanted(*args)
    holds), one per shape of its arguments, at most `keep`: cloned before
    the call, except the first `by_ref` (K2's table, which the call
    updates in place and scatter_add_case clones itself: a copy here
    would count in the path's peak memory). Yields {shapes: args}; a
    caller may empty it to record the next calls."""
    seen, wrapper = {}, getattr(module, attr)

    def recording(*args):
        key = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                    for a in args)
        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        if len(seen) < keep and key not in seen and not capturing and (
                wanted is None or wanted(*args)):
            seen[key] = tuple(a.clone() if isinstance(a, torch.Tensor)
                              and i >= by_ref else a
                              for i, a in enumerate(args))
        return wrapper(*args)

    setattr(module, attr, recording)
    try:
        yield seen
    finally:
        setattr(module, attr, wrapper)


class _Axes:
    def __init__(self, bars):
        self.bars = bars

    def bar(self, x, heights, *args, **kwargs):
        self.bars.append([float(h) for h in heights])

    def __getattr__(self, name):
        return lambda *a, **k: None


def plotted_latency(visualization, boards):
    """visualization.plot_latency over `boards`: the bars it drew (train
    ms, test ms, K ex/s), read from matplotlib's calls. Where the card's
    machine has no matplotlib, a recording stand-in takes its place for
    this call, so the loading and the values are checked all the same."""
    import importlib.util
    import types
    bars = []
    axes = (_Axes(bars), _Axes(bars))
    out = os.path.join(boards, "latency.png")
    if importlib.util.find_spec("matplotlib") is None:
        plt = types.SimpleNamespace(
            subplots=lambda *a, **k: (types.SimpleNamespace(
                tight_layout=lambda: None, savefig=lambda *a, **k: None),
                axes))
        mpl = types.SimpleNamespace(use=lambda *a: None, pyplot=plt)
        saved = {k: sys.modules.get(k) for k in ("matplotlib",
                                                 "matplotlib.pyplot")}
        sys.modules["matplotlib"], sys.modules["matplotlib.pyplot"] = mpl, plt
        try:
            visualization.plot_latency(boards, out)
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
        return {"matplotlib": False, "bars": bars}
    import matplotlib.pyplot as plt
    real = plt.subplots

    def recording(*a, **k):
        fig, (a1, a2) = real(*a, **k)
        for ax in (a1, a2):
            orig = ax.bar

            def bar(x, h, *args, _orig=orig, **kw):
                bars.append([float(v) for v in h])
                return _orig(x, h, *args, **kw)
            ax.bar = bar
        return fig, (a1, a2)
    plt.subplots = recording
    try:
        visualization.plot_latency(boards, out)
    finally:
        plt.subplots = real
    if not os.path.getsize(out):
        raise AssertionError("latency_grid: plot_latency wrote no figure")
    return {"matplotlib": True, "bars": bars, "png_bytes":
            os.path.getsize(out)}


def phase_latency_grid(tool, visualization, scatter_add, kernels, root,
                       device="cuda"):
    """tools/latency_grid_torch.py, all five methods, TOOL_WINDOWS x
    TOOL_STEPS: the JAX record's keys, finite positive times, each
    method's launches as its apply routes predict (K1 once a CAFE step, K2
    once a step per table of >= 2^20 rows at dim 128), every method
    graphed, and each latency.json read back by plot_latency.
    K2 is held against its plain version on the inputs each method's
    first eager step that lands a lane gave it (scatter_add_case)."""
    boards = os.path.join(root, "latency_boards")
    want, k2_cases = {}, {}

    _zero(kernels)
    with tool_log("latency_grid"), first_inputs(
            scatter_add, "scatter_add_", wanted=lands, by_ref=1) as k2:
        def on_method(rec, embed, state):
            per = predicted_launches(embed, state, rec["train_batch"])
            want[rec["method"]] = {k: v * rec["train_steps"]
                                   for k, v in per.items()}
            for args in k2.values():
                k2_cases[rec["method"]] = scatter_add_case(scatter_add,
                                                           *args)
            k2.clear()

        recs = tool.main(["--steps", str(TOOL_STEPS), "--windows",
                          str(TOOL_WINDOWS), "--boards", boards,
                          "--device", device], on_method=on_method)
    if [r["method"] for r in recs] != tool.METHODS:
        raise AssertionError(f"latency_grid: methods {recs}")
    for r in recs:
        m = r["method"]
        if LATENCY_KEYS - set(r):
            raise AssertionError(f"latency_grid {m}: missing "
                                 f"{LATENCY_KEYS - set(r)}")
        positive(f"latency_grid {m}", {
            k: r[k] for k in ("train_ms_per_it", "test_ms_per_it",
                              "examples_per_s", "table_rows", "loss")})
        bad = {k: (r["launches"][k], v) for k, v in want[m].items()
               if r["launches"][k] != v}
        if bad:
            raise AssertionError(f"latency_grid {m}: launches (got, want) "
                                 f"{bad}")
        if r["graphed"] != (device == "cuda"):
            raise AssertionError(f"latency_grid {m}: graphed {r['graphed']}"
                                 f" {r['capture_blockers']}")
    # CAFE's 3.2 M-row table takes K2 on the card
    if not want["cafe"]["land_max"] or (device == "cuda"
                                        and not want["cafe"]["scatter_add"]):
        raise AssertionError(f"latency_grid: CAFE launched no K1 or K2: "
                             f"{want['cafe']}")
    k2_methods = sorted(m for m, w in want.items() if w["scatter_add"])
    if sorted(k2_cases) != k2_methods:
        raise AssertionError(f"latency_grid: K2 held at {sorted(k2_cases)}"
                             f", launched by {k2_methods}")
    plot = plotted_latency(visualization, boards)
    by_name = sorted(recs, key=lambda r: r["method"])
    if plot["bars"][:2] != [[r["train_ms_per_it"] for r in by_name],
                            [r["test_ms_per_it"] for r in by_name]]:
        raise AssertionError(f"latency_grid: plot_latency read "
                             f"{plot['bars'][:2]}")
    launches = {name: sum(r["launches"][name] for r in recs)
                for name in kernels}
    return {"records": recs, "plot_latency": plot, "launches": launches,
            "launches_predicted": want, "scatter_add_cases": k2_cases}


def phase_step_breakdown(tool, kernels, device="cuda"):
    """tools/step_breakdown_torch.py, both grids, every arm eager and
    graphed (cafe_iv8's skipped inserts are conditional nodes): finite
    positive us a step; K1 once a CAFE train step (at cafe_iv8 once an
    insert that ran, warm-up spares included: the tool's `inserts`),
    never on a forward-only arm, and on the dim-128 grid K2 once a train
    step."""
    out, launches = {}, {name: 0 for name in kernels}
    n = BREAKDOWN_WARMUP + TOOL_STEPS
    for shapes in ("criteo", "criteotb"):
        with tool_log(f"step_breakdown_{shapes}"):
            res = tool.main(["--shapes", shapes, "--steps", str(TOOL_STEPS),
                             "--warmup", str(BREAKDOWN_WARMUP), "--device",
                             device])
        torch.cuda.empty_cache()
        modes = [m for m in ("eager", "graphed") if m in res]
        for mode in modes:
            positive(f"step_breakdown {shapes} {mode}", res[mode])
        graphed = set(res["graphed"]) if "graphed" in res else set()
        for name, got in res["launches"].items():
            n_modes = 1 + (name in graphed)
            k1 = (res["inserts"][name] if name.endswith("iv8")
                  else n * n_modes) if name.startswith("cafe") else 0
            if got["land_max"] != k1:
                raise AssertionError(f"step_breakdown {shapes} {name}: K1 "
                                     f"{got['land_max']}, not {k1}")
            # at dim 128 each arm's one table of >= 2^20 rows takes K2
            k2 = n * n_modes if shapes == "criteotb" and device == "cuda" \
                else 0
            if got["scatter_add"] != k2:
                raise AssertionError(f"step_breakdown {shapes} {name}: K2 "
                                     f"{got['scatter_add']}, not {k2}")
            for k, v in got.items():
                launches[k] += v
        if device == "cuda" and res["not_graphed"]:
            raise AssertionError(f"step_breakdown {shapes}: not graphed "
                                 f"{res['not_graphed']}")
        out[shapes] = res
    return {**out, "launches": launches}


def phase_profile_step(tool, root, kernels, device="cuda"):
    """tools/profile_step_torch.py: 5 fused K = 8 dispatches graphed under
    torch.profiler; the replays traced (no fall-back to the eager step),
    K1's kernel among their device ops, one a step."""
    _zero(kernels)
    with tool_log("profile_step"):
        rec = tool.main(["--steps", "5", "--out",
                         os.path.join(root, "profile_step"), "--device",
                         device])
    launches = _counts(kernels)
    if device == "cuda":
        if not rec["graphed"] or rec["fell_back_to_eager"]:
            raise AssertionError(f"profile_step: graphed {rec['graphed']}, "
                                 f"fell back {rec['fell_back_to_eager']}")
        k1 = {k: v for k, v in rec["kernels"].items() if "land_max" in k}
        if sum(k1.values()) != 5 * tool.DISPATCH_K:
            raise AssertionError(f"profile_step: K1 kernels {k1} in the "
                                 f"trace, not {5 * tool.DISPATCH_K}")
    positive("profile_step", rec["lanes"])
    kernels_seen = rec.pop("kernels")
    rec.pop("trace")
    top = sorted(kernels_seen.items(), key=lambda kv: -kv[1])[:12]
    return {**rec, "launches": launches,
            "device_kernels": sum(kernels_seen.values()),
            "k1_kernels": sum(v for k, v in kernels_seen.items()
                              if "land_max" in k),
            "top_kernels_by_count": [[k[:100], v] for k, v in top]}


def phase_profile_train(tool, kernels, device="cuda"):
    """tools/profile_train_torch.py (eager, 4 steps): the lines account
    for at least its MIN_ATTRIBUTED of the device-busy time."""
    _zero(kernels)
    with tool_log("profile_train"):
        rec = tool.profile(reps=4, device=device, top=30)
    if rec["attributed_share"] < tool.MIN_ATTRIBUTED:
        raise AssertionError(f"profile_train: attributed "
                             f"{rec['attributed_share']}")
    positive("profile_train", {"total_us_per_rep":
                               rec["total_us_per_rep"]})
    top = sorted(rec["lines"].items(), key=lambda kv: -kv[1][0])[:15]
    return {**{k: v for k, v in rec.items() if k not in ("lines", "trace")},
            "top_lines": top, "launches": _counts(kernels)}


def _auc_ok(name, aucs):
    if not all(np.isfinite(a) and 0.0 < a <= 1.0 for a in aucs):
        raise AssertionError(f"{name}: AUCs {aucs}")


def phase_variance(tool, land, kernels, device="cuda", **size):
    """tools/variance_cafe_vs_hash_torch.py at full size, graphed: three
    seeds, finite AUCs, K1 once a CAFE step, and K1 on the inputs the
    first eager CAFE step gave it (land_real_case)."""
    _zero(kernels)
    t0 = time.perf_counter()
    with tool_log("variance_cafe_vs_hash"), first_inputs(
            land, "land_max") as k1:
        rec = tool.run(device=device, **size)
    rec["wall_s"] = time.perf_counter() - t0
    _auc_ok("variance", rec["auc"]["hash"] + rec["auc"]["cafe"])
    launches = _counts(kernels)
    if device == "cuda" and not rec["graphed"]:
        raise AssertionError("variance: the steps did not graph")
    if launches["land_max"] != len(rec["seeds"]) * rec["steps"]:
        raise AssertionError(f"variance: K1 {launches['land_max']}, not "
                             f"{len(rec['seeds'])} x {rec['steps']}")
    return {**rec, "launches": launches,
            "land_max_cases": [land_real_case(land, *a) for a in k1.values()]}


def phase_sweep(tool, land, kernels, device="cuda", **size):
    """tools/sweep_cafe_vs_hash_torch.py, its first SWEEP_POINTS grid
    points (two seeds each): finite AUCs, K1 once a CAFE step, and K1 on
    the inputs the first eager CAFE step gave it (land_real_case)."""
    _zero(kernels)
    t0 = time.perf_counter()
    with tool_log("sweep_cafe_vs_hash"), first_inputs(land,
                                                      "land_max") as k1:
        recs = tool.run(points=SWEEP_POINTS, device=device, **size)
    _auc_ok("sweep", [r[m] for r in recs for m in ("hash", "cafe")])
    launches = _counts(kernels)
    want = sum(r["steps"] for r in recs)
    if len(recs) != 2 * SWEEP_POINTS or launches["land_max"] != want:
        raise AssertionError(f"sweep: {len(recs)} records, K1 "
                             f"{launches['land_max']} (want {want})")
    return {"records": recs, "wall_s": time.perf_counter() - t0,
            "launches": launches,
            "land_max_cases": [land_real_case(land, *a) for a in k1.values()]}


def phase_ab_apply128(tool, scatter_add, kernels, warmup_calls,
                      device="cuda"):
    """tools/ab_apply128_torch.py, TOOL_WINDOWS x TOOL_STEPS: K2 within
    its numerics bound, every arm's median finite and positive, every arm
    graphed on the card, K2 launched once a call of the pallas arm's
    chains (its `warmup_calls` eager chains, the capture's replay, the
    tool's warm replay and the windows) and of the numerics check; then
    K2 held against its plain version on the first inputs each level
    gave it (scatter_add_case)."""
    _zero(kernels)
    with tool_log("ab_apply128"), first_inputs(scatter_add, "scatter_add_",
                                               keep=3, by_ref=1) as k2:
        lines = tool.main(["--windows", str(TOOL_WINDOWS), "--steps",
                           str(TOOL_STEPS), "--device", device])
    num, levels = lines[0], lines[1:]
    if not num["pass"]:
        raise AssertionError(f"ab_apply128: numerics {num}")
    for rec in levels:
        positive(f"ab_apply128 {rec['level']}",
                 {k: rec[k] for k in tool.ARMS})
        if device == "cuda" and not rec["graphed"]:
            raise AssertionError(f"ab_apply128 {rec['level']}: not graphed")
    launches = _counts(kernels)
    chains = TOOL_WINDOWS + 1 + (warmup_calls + 1 if device == "cuda"
                                 else 0)
    want = 1 + len(levels) * chains * TOOL_STEPS
    if launches["scatter_add"] != want:
        raise AssertionError(f"ab_apply128: K2 {launches['scatter_add']}, "
                             f"not {want}")
    cases = {f"{a[0].shape[0]}x{a[0].shape[1]}": scatter_add_case(
        scatter_add, *a) for a in k2.values()}
    want_shapes = {f"{r['rows']}x{r['dim']}" for r in levels}
    if not want_shapes <= set(cases):
        raise AssertionError(f"ab_apply128: K2 held at {sorted(cases)}, "
                             f"not at every level {sorted(want_shapes)}")
    return {"lines": lines, "launches": launches,
            "scatter_add_cases": cases}


def phase_ab_interact(tool, kernels, device="cuda", **size):
    """tools/ab_interact_torch.py, TOOL_WINDOWS windows of TOOL_STEPS
    reps, each chain one CUDA graph: every arm within the bf16 bound of
    its exact product, its kernels named from the profiler."""
    _zero(kernels)
    with tool_log("ab_interact"):
        rec = tool.run(TOOL_WINDOWS, TOOL_STEPS, device, **size)
    positive("ab_interact", rec["median_us"])
    if device == "cuda" and not (rec["graphed"] and all(rec["kernels"]
                                                        .values())):
        raise AssertionError(f"ab_interact: graphed {rec['graphed']}, "
                             f"kernels {rec['kernels']}")
    return {**rec, "launches": _counts(kernels)}


def phase_ab_scatter_vs_sorted(tool, kernels, device="cuda"):
    """tools/ab_scatter_vs_sorted_torch.py with --sparse_apply_impl dense,
    TOOL_WINDOWS windows of TOOL_STEPS reps: finite positive medians, K3
    once an SGD scatter call (the 27,136 x 16 table takes its route)."""
    _zero(kernels)
    with tool_log("ab_scatter_vs_sorted"):
        rec = tool.main(["--reps", str(TOOL_STEPS), "--windows",
                         str(TOOL_WINDOWS), "--sparse_apply_impl", "dense",
                         "--device", device])
    positive("ab_scatter_vs_sorted", rec["median_us"])
    launches = _counts(kernels)
    want = (1 + TOOL_WINDOWS) * TOOL_STEPS
    if launches["rowsum"] != want:
        raise AssertionError(f"ab_scatter_vs_sorted: K3 "
                             f"{launches['rowsum']}, not {want}")
    return {**rec, "launches": launches}


def phase_reset_cost(tool, kernels, device="cuda"):
    """tools/reset_cost_torch.py at its defaults (lim 1,000,000, 53,248
    lanes), TOOL_WINDOWS windows, a 100-step Zipf stream: finite positive
    times of its three arms (the reset's branch untaken, taken every
    call, absent), all graphed, the fires counted."""
    _zero(kernels)
    with tool_log("reset_cost"):
        rec = tool.main(["--windows", str(TOOL_WINDOWS), "--stream_steps",
                         "100", "--device", device])
    if RESET_KEYS - set(rec):
        raise AssertionError(f"reset_cost: missing {RESET_KEYS - set(rec)}")
    positive("reset_cost", {k: rec[k] for k in ("steady_us",
                                                 "forced_reset_us",
                                                 "no_reset_us")})
    if device == "cuda" and not rec["graphed"]:
        raise AssertionError("reset_cost: the arms did not graph")
    return {**rec, "launches": _counts(kernels)}


def phase_probes(overhead, micro, clock, device="cuda"):
    """The three probes: kernel_overhead_probe (eager and graphed,
    TOOL_WINDOWS windows), micro_ops (one graph), clock_probe (at most
    1.05 of the bf16 peak)."""
    with tool_log("kernel_overhead_probe"):
        over = overhead.main(["--windows", str(TOOL_WINDOWS), "--device",
                              device])
    for r in over:
        if OVERHEAD_KEYS - set(r):
            raise AssertionError(f"kernel_overhead_probe: {r}")
        positive(f"kernel_overhead_probe {r['shape']} {r['mode']}",
                 {k: r[k] for k in ("us_k16", "us_k128", "us_per_kernel")})
    with tool_log("micro_ops"):
        ops = micro.main(["--device", device])
    positive("micro_ops", ops["us_per_op"])
    with tool_log("clock_probe"):
        clk = clock.main(["--device", device])
    positive("clock_probe", {k: min(v) for k, v in clk["tflops"].items()})
    if clk["max_share_of_peak"] > 1.05:
        raise AssertionError(f"clock_probe: {clk['max_share_of_peak']} of "
                             f"the bf16 peak: the clock is wrong")
    return {"kernel_overhead_probe": over, "micro_ops": ops,
            "clock_probe": clk}


def phase_launcher(data_path, root, cpu=False):
    """bench/criteo_kaggle_torch.sh with DATA = the preprocessed data and
    $1 capping it at 220 iterations of 1024 rows (CAFE, cr 1e-3, the dense
    apply): exit 0 and a finite AUC on its last eval line (its process
    launches its own kernels; they are not counted here)."""
    here = os.path.dirname(os.path.abspath(__file__))
    flags = LAUNCHER_FLAGS + ["--tensor_board_filename",
                              os.path.join(root, "launcher_board")]
    if cpu:
        flags += ["--force_platform", "cpu"]
    t0 = time.perf_counter()
    out = subprocess.run(
        ["bash", os.path.join(here, "bench", "criteo_kaggle_torch.sh"),
         " ".join(flags)], cwd=here, capture_output=True, text=True,
        env={**os.environ, "DATA": data_path}, timeout=600)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "tools_launcher_criteo_kaggle.txt"),
              "w") as f:
        f.write(out.stdout + out.stderr)
    log = os.path.join(here, "run_kaggle_torch.log")
    if os.path.exists(log):
        os.remove(log)
    aucs = [float(m) for m in re.findall(r"auc ([0-9.]+) %", out.stdout)]
    its = re.findall(r"Finished training it (\d+)/(\d+)", out.stdout)
    if out.returncode != 0 or not aucs or not np.isfinite(aucs[-1]):
        raise AssertionError(f"launcher_criteo_kaggle: rc {out.returncode}"
                             f", AUC lines {aucs}: {out.stdout[-800:]}"
                             f"{out.stderr[-800:]}")
    return {"return_code": out.returncode, "auc_percent": aucs[-1],
            "iterations": int(its[-1][1]) if its else None, "wall_s": wall}


TRAFFIC_METHODS = ["hash", "cafe"]
SUMMARY_SECTIONS = ("## Clock probe", "## Headline (chip_smoke.py",
                    "## Stage budget — dim 16", "## Stage budget — dim 128",
                    "## Perf decisions")


def phase_traffic_table(tool, land, kernels, device="cuda"):
    """tools/traffic_table_torch.py's rows at world size 1 on `device`
    and on the CPU, in this process (module docstring, phase 64), and K1
    on the inputs the card's CAFE step gave it (land_real_case)."""
    _zero(kernels)
    with tool_log("traffic_table"):
        with first_inputs(land, "land_max") as k1:
            card = tool.rows(1, 0, TRAFFIC_METHODS, device=device)
        launches = _counts(kernels)
        cpu = tool.rows(1, 0, TRAFFIC_METHODS, device="cpu")
        for r in card:
            print(tool.format_row(r))
    for c, h in zip(card, cpu):
        if (c["hlo_total"], c["by_op"]) != (h["hlo_total"], h["by_op"]):
            raise AssertionError(f"traffic_table {c['method']}: card "
                                 f"{c['hlo_total']} {c['by_op']}, CPU "
                                 f"{h['hlo_total']} {h['by_op']}")
        for r in (c, h):
            if r["model_total"] and not tool.passes(r):
                raise AssertionError(f"traffic_table {r['method']}: ratio "
                                     f"{tool.ratio(r)}, {r['over']} over "
                                     f"the bound")
    want = 1 if device == "cuda" else 0
    if launches["land_max"] != want:
        raise AssertionError(f"traffic_table: K1 launched "
                             f"{launches['land_max']} times, not {want}")
    return {"card": card, "cpu": cpu,
            "ratio": {r["method"]: tool.ratio(r) for r in card},
            "launches": launches,
            "land_max_cases": [land_real_case(land, *a) for a in k1.values()]}


BENCH_STEPS, BENCH_WARMUP = 10, 4     # bench_torch's phase: one window
# bench.py's JSON line (bench.py:260-274), and the port's two keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "window_min",
              "window_max", "windows", "steps_per_dispatch", "mfu",
              "flops_per_example", "cafe_insert_interval",
              "interval8_examples_per_s", "cr1e4_examples_per_s",
              "dim128_examples_per_s", "sync", "device", "graphed"}


def bench_k1_want(bench, warmup_calls, steps=BENCH_STEPS,
                  warmup=BENCH_WARMUP):
    """(all, in graphs) K1 launches of phase_bench_torch's run on the
    card: one an insert; every step inserts at interval 1 (the headline,
    cr 1e-4, dim 128), every 8th step at interval 8, whose warm-up calls
    also run each skipped step's insert on clones (utils/cond.cond); the
    first `warmup_calls` calls of each configuration run eagerly."""
    k = bench.DISPATCH_K
    per_k = (warmup + steps) * k                # steps of a K-step config
    dim128 = warmup + bench.extra_configs(
        bench.headline_config())["dim128"][1]["steps"]
    warm_steps = warmup_calls * k
    iv8 = -(-per_k // 8) + warm_steps - -(-warm_steps // 8)
    total = 2 * per_k + iv8 + dim128
    return total, total - warmup_calls * (3 * k + 1)


def phase_bench_torch(bench, land, kernels, warmup_calls, device="cuda",
                      **size):
    """bench_torch.main at one window of BENCH_STEPS calls after
    BENCH_WARMUP (its measure of each of the four configurations): one
    line with bench.py's keys, "device" and "graphed", every rate
    positive and, on the card, graphed with 0 < MFU <= 1, exit code 0;
    K1's launches, all and in graphs, as bench_k1_want counts them (0 on
    the CPU); and K1 on the first inputs each configuration's insert gave
    it (land_real_case: cr 1e-4's 10-fold fewer buckets and dim 128's
    CriteoTB sketch are shapes no other phase gives it)."""
    _zero(kernels)
    in_graphs0 = kernels["land_max"].graph_launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), first_inputs(
            land, "land_max", keep=4) as k1:
        rc = bench.main(device=device, windows=1, extra_windows=1,
                        steps=BENCH_STEPS, warmup=BENCH_WARMUP, **size)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench_torch: rc {rc}, lines {lines}")
    rec = json.loads(lines[0])
    if set(rec) != BENCH_KEYS:
        raise AssertionError(f"bench_torch: keys {sorted(rec)}")
    rates = {k: rec[k] for k in ("value", "interval8_examples_per_s",
                                 "cr1e4_examples_per_s",
                                 "dim128_examples_per_s")}
    positive("bench_torch", rates)
    launches = _counts(kernels)
    got = (launches["land_max"],
           kernels["land_max"].graph_launches - in_graphs0)
    want = bench_k1_want(bench, warmup_calls) if device == "cuda" \
        else (0, 0)
    if device == "cuda" and (not all(rec["graphed"].values())
                             or not 0 < rec["mfu"] <= 1):
        raise AssertionError(f"bench_torch: graphed {rec['graphed']}, "
                             f"mfu {rec['mfu']}")
    if got != want:
        raise AssertionError(f"bench_torch: K1 launched {got} times (all, "
                             f"in graphs), not {want}")
    return {"line": rec, "launches": launches,
            "land_max_want": list(want),
            "land_max_cases": [land_real_case(land, *a) for a in k1.values()]}


def phase_perf_report(tool, headline_ms):
    """tools/perf_report_torch.py over this run's OUT_DIR (module
    docstring, phase 65)."""
    with tool_log("perf_report"):
        text = tool.main([OUT_DIR])
    path = os.path.join(OUT_DIR, "SUMMARY.md")
    with open(path) as f:
        if f.read() != text:
            raise AssertionError("perf_report: SUMMARY.md is not the digest")
    missing = [h for h in SUMMARY_SECTIONS if h not in text]
    if missing:
        raise AssertionError(f"perf_report: sections {missing} missing")
    if "clock VALID" not in text or "WARNING" in text:
        raise AssertionError("perf_report: the clock is not VALID")
    ms = float(re.search(r"\*\*([0-9.]+) ms a step\*\*", text).group(1))
    if ms != headline_ms:
        raise AssertionError(f"perf_report: headline {ms} ms a step, "
                             f"headline_graph {headline_ms}")
    return {"summary": path, "sections": list(SUMMARY_SECTIONS),
            "headline_ms_per_step": ms, "chars": len(text)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cafe_tpu_torch.bridge import from_reference, to_numpy
    from cafe_tpu_torch.config import Config, parse_args
    import main_graphrec_torch
    import main_torch
    from cafe_tpu_torch.data import (CTRArrays, make_criteo_arrays,
                                     make_criteo_batches, num_batches)
    from cafe_tpu_torch.kernels import (KERNELS, a2a, build, gather, land,
                                        rowsum, scatter_add)
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from cafe_tpu_torch.ops.quantized import (dequantize_rows,
                                              quantize_rowwise)
    from cafe_tpu_torch import native
    from cafe_tpu_torch.data import preprocess
    from cafe_tpu_torch.tools import (criteo_grid, job_scheduler,
                                      process_interactions, roofline,
                                      visualization, wire_audit)
    from cafe_tpu_torch.tools.export_model import export_eval_step
    from cafe_tpu_torch.train import (build_all, build_multi_step,
                                      build_quantized_eval_step, run)
    from cafe_tpu_torch.train.loop import pretrain_autoencoders
    from cafe_tpu_torch.train.capture import (WARMUP_CALLS, branch_runs,
                                              copy_into)
    from cafe_tpu_torch.train.checkpoint import load_tree
    from cafe_tpu_torch.train.step import (_bce, build_eval_step,
                                           build_train_step, clone_state,
                                           init_state)
    from cafe_tpu_torch.utils.timing import fence

    if os.path.exists(os.path.join(OUT_DIR, "chip_smoke.jsonl")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke.jsonl"))
    memo_table_draws()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 towers stay f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": {src: [ln.split(":", 1)[-1].strip()
                          for ln in log.splitlines() if "Used" in ln]
                    for src, log in reports.items()}})

    kern = phase_kernels(land, scatter_add)

    data, batches = make_criteo_batches(batch=2048, n_batches=8)
    batches_cpu = [(d.cpu(), s.cpu(), l.cpu(), v)
                   for d, s, l, v in batches[:3]]
    by_path = {}

    def check_launches(name, rec, want):
        for k, n in want.items():
            if rec["launches"][k] != n:
                raise AssertionError(f"{name}: {k} launched "
                                     f"{rec['launches'][k]} times, not {n}")
        by_path[name] = rec["launches"]

    state, embed, head = drive(build_all, fence, headline_cfg(Config), data,
                               batches, KERNELS, HEADLINE_STEPS, WINDOWS)
    check_launches("headline", head, {"land_max": head["steps"]})
    emit({"phase": "headline", **head})

    kern["rowsum"] = phase_rowsum(rowsum, embed, state, batches)
    emit({"phase": "kernels_rowsum", **kern["rowsum"]})
    kern["gather"] = phase_gather(gather, embed, state, batches)
    emit({"phase": "kernels_gather", **kern["gather"]})
    quant = phase_quant_parity(quantize_rowwise, dequantize_rows, {
        "headline": state.embed[cafe_key(embed)[1]]["table"]})
    del state, embed

    state, _, dense = drive(build_all, fence,
                            headline_cfg(Config, sparse_apply_impl="dense"),
                            data, batches, KERNELS, HEADLINE_STEPS, WINDOWS)
    del state
    check_launches("headline_dense", dense,
                   {"land_max": dense["steps"], "rowsum": dense["steps"],
                    "scatter_add": 0})
    emit({"phase": "headline_dense", **dense})

    for impl in ("auto", "dense"):
        emit({"phase": "parity", **phase_parity(
            build_all, from_reference, to_numpy, Config, data, batches_cpu,
            batches, impl)})

    cfg128 = headline_cfg(Config, dataset="criteotb", embedding_dim=128,
                          compress_rate=0.1, learning_rate=1.0)
    state, sib_embed, sib = drive(build_all, fence, cfg128, data, batches,
                                  KERNELS, SIBLING_STEPS, 1)
    quant.update(phase_quant_parity(quantize_rowwise, dequantize_rows, {
        "sibling": state.embed[cafe_key(sib_embed)[1]]["table"]}))
    del state, sib_embed
    check_launches("sibling", sib, {"land_max": sib["steps"],
                                    "scatter_add": sib["steps"]})
    emit({"phase": "sibling", **sib})
    emit({"phase": "quant_parity", **quant})
    torch.cuda.empty_cache()

    for name, cfg in (("headline", headline_cfg(Config)),
                      ("headline_dense",
                       headline_cfg(Config, sparse_apply_impl="dense"))):
        emit({"phase": f"profile_{name}", **phase_profile(
            build_all, cfg, data, batches, name)})

    # ---- the compiled step: CUDA graphs beside the eager steps
    in_graphs = {}
    v1_graphed = {}

    def graph_launches():
        return {name: k.graph_launches for name, k in KERNELS.items()}

    def count_in_graphs(path, before):
        in_graphs[path] = {name: n - before[name]
                           for name, n in graph_launches().items()}

    for name, cfg in (("headline_graph", headline_cfg(Config)),
                      ("headline_dense_graph",
                       headline_cfg(Config, sparse_apply_impl="dense")),
                      ("sibling_graph", cfg128)):
        before = graph_launches()
        rec = phase_graph(build_all, build_train_step, WARMUP_CALLS, fence,
                          cfg, data, batches, KERNELS)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        torch.cuda.empty_cache()
        rec["replay_equals_eager"] = gate_replay(
            build_all, build_train_step, clone_state, from_reference,
            to_numpy, _bce, dataclasses.replace(
                cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0),
            data, batches, exact_tables=cfg.sparse_apply_impl == "dense")
        torch.cuda.empty_cache()
        v1_graphed[name] = rec["graphed_ms_per_step"]
        emit({"phase": name, **rec})

    # ---- CAFE+ (the two-tier sketch) graphed beside eager, with its gates
    plus_fns = (build_all, build_train_step, WARMUP_CALLS, fence,
                clone_state, from_reference, to_numpy, _bce)
    for name, (cfg, want) in plus_configs(Config, cfg128).items():
        before = graph_launches()
        rec = phase_plus(name, cfg, want, plus_fns, data, batches,
                         batches_cpu, KERNELS)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        v1 = {"cafe_plus_dense": "headline_dense_graph",
              "cafe_plus_sibling": "sibling_graph"}.get(name,
                                                        "headline_graph")
        rec["v1_graphed_ms_per_step_same_call"] = v1_graphed[v1]
        rec["vs_v1_graphed"] = rec["graphed_ms_per_step"] / v1_graphed[v1]
        emit({"phase": name, **rec})
    for name, cfg in (("headline", headline_cfg(Config, cafe_plus=True)),
                      ("sibling", dataclasses.replace(cfg128,
                                                      cafe_plus=True))):
        emit({"phase": f"plus_reset_cost_{name}", **phase_plus_reset_cost(
            build_all, cfg, data, batches)})
    # ---- the device branches (utils/cond.cond) graphed beside eager
    before = graph_launches()
    t0 = time.perf_counter()
    cc = phase_cond_capture(build_all, build_train_step, clone_state,
                            from_reference, to_numpy, fence, Config, data,
                            batches, KERNELS)
    count_in_graphs("cond_capture", before)
    by_path["cond_capture"] = {name: sum(r["launches"][name]
                                         for r in cc.values())
                               for name in KERNELS}
    emit({"phase": "cond_capture", "wall_s": time.perf_counter() - t0,
          **cc})
    torch.cuda.empty_cache()
    emit({"phase": "profile_cafe_plus_graph", **phase_profile(
        build_all, headline_cfg(Config, cafe_plus=True), data, batches,
        "cafe_plus_graph", capture=True, landings=0)})
    emit({"phase": "eval_graph", **phase_eval_graph(
        build_all, headline_cfg(Config), data, batches, WARMUP_CALLS)})
    emit({"phase": "profile_headline_graph", **phase_profile(
        build_all, headline_cfg(Config), data, batches, "headline_graph",
        capture=True)})

    # ---- quantized serving and the export
    serving = phase_serving_quant(load_tool("serving_bench_torch"))
    emit({"phase": "serving_quant", **serving})
    emit({"phase": "serving_packed", **phase_serving_packed(
        build_all, build_quantized_eval_step, Config, data, batches,
        serving, WARMUP_CALLS)})
    emit({"phase": "export", **phase_export(
        build_all, export_eval_step, headline_cfg(Config), data, batches)})
    torch.cuda.empty_cache()

    before = graph_launches()
    cli = phase_cli(main_torch.main, make_criteo_arrays, KERNELS,
                    quant_bits=QUANT_BITS)
    count_in_graphs("cli", before)
    by_path["cli"] = cli["run_a"]["launches"]
    by_path["cli_throughput"] = cli["run_c"]["launches"]
    cli_quant = cli.pop("quant")
    emit({"phase": "cli", **cli})
    emit({"phase": "cli_quant", **cli_quant})
    before = graph_launches()
    clip = phase_cli(main_torch.main, make_criteo_arrays, KERNELS,
                     extra=["--cafe_plus", "true"],
                     want={"land_max": 0, "rowsum": 48}, tag="cli_plus",
                     quant_bits=QUANT_BITS)
    count_in_graphs("cli_plus", before)
    by_path["cli_plus"] = clip["run_a"]["launches"]
    by_path["cli_plus_throughput"] = clip["run_c"]["launches"]
    emit({"phase": "cli_plus", **clip})
    before = graph_launches()
    timing = cli_timing(
        main_torch.main, lambda argv: run(parse_args(argv), capture=False),
        make_criteo_arrays, KERNELS)
    count_in_graphs("cli_timing", before)
    by_path["cli_timing"] = {
        name: sum(r["launches"][name] for r in timing.values()
                  if isinstance(r, dict) and "launches" in r)
        for name in KERNELS}
    emit({"phase": "cli_timing", **timing})

    # ---- the sharded slice at world size 1: NCCL on the card, and a
    # gloo group of 1 for the CPU side of the parity
    maybe_init_distributed(Config(), "cuda")
    mesh_gpu = make_mesh(1, device="cuda")
    mesh_cpu = make_mesh(1, device="cpu")
    kern["a2a"] = phase_a2a(a2a, mesh_gpu)
    emit({"phase": "kernels_a2a", **kern["a2a"]})

    cfg_sh = headline_cfg(Config, mesh_shape=1, shard_embeddings=True,
                          shard_exchange="pallas")
    state, _, shd = drive(build_all, fence, cfg_sh, data, batches, KERNELS,
                          HEADLINE_STEPS, WINDOWS, mesh=mesh_gpu)
    del state
    check_launches("sharded", shd, {"land_max": shd["steps"],
                                    "a2a": 4 * shd["steps"]})
    shd["headline_ms_per_step_same_call"] = head["ms_per_step"]
    shd["vs_headline"] = shd["ms_per_step"] / head["ms_per_step"]
    emit({"phase": "sharded", **shd})
    emit({"phase": "sharded_parity", **phase_sharded_parity(
        build_all, from_reference, to_numpy, Config, data, batches_cpu,
        batches, mesh_gpu, mesh_cpu)})
    emit({"phase": "profile_sharded", **phase_profile(
        build_all, cfg_sh, data, batches, "sharded", mesh=mesh_gpu)})
    cfg_shp = dataclasses.replace(cfg_sh, cafe_plus=True)
    state, _, shp = drive(build_all, fence, cfg_shp, data, batches, KERNELS,
                          HEADLINE_STEPS, 2, mesh=mesh_gpu)
    del state
    check_launches("sharded_plus", shp, {"land_max": 0,
                                         "a2a": 4 * shp["steps"]})
    emit({"phase": "sharded_plus", **shp})
    emit({"phase": "sharded_parity_plus", **phase_sharded_parity(
        build_all, from_reference, to_numpy, Config, data, batches_cpu,
        batches, mesh_gpu, mesh_cpu, plus=True)})
    for cfg in (cfg_sh, cfg_shp):
        emit({"phase": "sharded_quant", **phase_sharded_quant(
            build_all, init_state, copy_into, build_quantized_eval_step,
            cfg, data, batches, mesh_gpu)})

    # ---- the mesh's steps in CUDA graphs beside their eager twins
    t0 = time.perf_counter()
    before = graph_launches()
    mg = phase_mesh_graph(
        (build_all, build_train_step, build_multi_step, clone_state, fence,
         branch_runs, WARMUP_CALLS),
        (build_eval_step, build_quantized_eval_step), Config, cfg128,
        data, batches, mesh_gpu, KERNELS)
    count_in_graphs("mesh_graph", before)
    by_path["mesh_graph"] = {name: sum(r["launches"][name]
                                       for r in mg.values())
                             for name in KERNELS}
    emit({"phase": "mesh_graph", "wall_s": time.perf_counter() - t0, **mg})

    t0 = time.perf_counter()
    before = graph_launches()
    clis = phase_cli_sharded(main_torch.main, make_criteo_arrays, KERNELS)
    count_in_graphs("cli_sharded", before)
    by_path["cli_sharded"] = clis["launches"]
    emit({"phase": "cli_sharded", "wall_s": time.perf_counter() - t0,
          **clis})

    # ---- QR, Off and AdaEmbed on the mesh; the unique-compact exchange
    t0 = time.perf_counter()
    shm = phase_sharded_methods(build_all, from_reference, to_numpy, _bce,
                                Config, data, batches, batches_cpu,
                                mesh_gpu, mesh_cpu, fence, KERNELS)
    by_path["sharded_methods"] = {
        name: sum(r["modes"][m]["launches"][name] for r in shm.values()
                  for m in SHARDED_MODES) for name in KERNELS}
    emit({"phase": "sharded_methods", "wall_s": time.perf_counter() - t0,
          **shm})
    t0 = time.perf_counter()
    emit({"phase": "sharded_methods_unique_compact", **phase_unique_compact(
        build_all, from_reference, to_numpy, Config, data, batches, mesh_gpu,
        fence), "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    before = graph_launches()
    clq = phase_cli_mesh(main_torch.main, make_criteo_arrays, KERNELS,
                         "sharded_methods_cli_qr")
    count_in_graphs("sharded_methods_cli_qr", before)
    by_path["sharded_methods_cli_qr"] = clq["launches"]
    emit({"phase": "sharded_methods_cli_qr",
          "wall_s": time.perf_counter() - t0, **clq})

    # ---- the rest of the mesh: auto, the two-level mesh, the wire audit
    t0 = time.perf_counter()
    sha = phase_sharded_auto(build_all, from_reference, to_numpy, _bce,
                             Config, cfg128, data, batches, batches_cpu,
                             mesh_gpu, mesh_cpu, fence, KERNELS)
    by_path["sharded_auto"] = {name: sum(r["launches"][name]
                                         for r in sha.values())
                               for name in KERNELS}
    emit({"phase": "sharded_auto", "wall_s": time.perf_counter() - t0,
          **sha})
    t0 = time.perf_counter()
    mesh_two = make_mesh(1, inner=1, device="cuda")
    shl = phase_sharded_two_level(build_all, from_reference, to_numpy,
                                  Config, data, batches, mesh_gpu, mesh_two,
                                  fence, KERNELS)
    mesh_two.close()
    by_path["sharded_two_level"] = shl["cafe"]["launches"]
    emit({"phase": "sharded_two_level", "wall_s": time.perf_counter() - t0,
          **shl})
    t0 = time.perf_counter()
    cla = {}
    for name in ("cli_auto", "cli_two_level"):
        before = graph_launches()
        cla[name] = phase_cli_mesh(main_torch.main, make_criteo_arrays,
                                   KERNELS, name)
        count_in_graphs(name, before)
        by_path[name] = cla[name]["launches"]
    emit({"phase": "cli_auto", "wall_s": time.perf_counter() - t0, **cla})
    t0 = time.perf_counter()
    emit({"phase": "wire_audit", **phase_wire_audit(
        wire_audit, make_criteo_arrays), "wall_s": time.perf_counter() - t0})
    mesh_gpu.close()
    mesh_cpu.close()
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- the graph recommenders (LightGCN, PinSAGE) and their driver
    land_shapes, rowsum_shapes = {}, {}
    for name, phase in (("graphrec_lightgcn", phase_graphrec_lightgcn),
                        ("graphrec_pinsage", phase_graphrec_pinsage)):
        t0 = time.perf_counter()
        rec = phase(main_graphrec_torch, land, load_tree, to_numpy, KERNELS)
        land_shapes[name] = rec["land_max_cases"]
        rowsum_shapes[name] = rec["rowsum_cases"]
        by_path[name] = rec["launches"]
        in_graphs[name] = rec["launches_in_graphs"]
        emit({"phase": name, "wall_s": time.perf_counter() - t0, **rec})
        torch.cuda.empty_cache()

    # ---- the measurement tools of the hot path (K4's path)
    abd = phase_ab_decisions(
        load_tool("ab_decisions_torch"), KERNELS,
        check_donate_off(build_all, build_multi_step, Config, data,
                         batches))
    by_path["ab_decisions"] = abd["launches"]
    emit({"phase": "ab_decisions", **abd})
    abl = phase_ab_insert_land(load_tool("ab_insert_land_torch"), KERNELS)
    by_path["ab_insert_land"] = abl["launches"]
    emit({"phase": "ab_insert_land", **abl})
    roof = phase_roofline(roofline, KERNELS)
    by_path["roofline"] = roof["launches"]
    emit({"phase": "roofline", **roof})

    # ---- the baseline methods and the other towers, full Kaggle width
    ae_data, ae_batches = modded_data(CTRArrays, data, batches,
                                      AE_MAX_IND_RANGE)
    ae_cpu = [(d.cpu(), s.cpu(), l.cpu(), v) for d, s, l, v in ae_batches]

    def pretrain(embed, state, dat, device):
        return pretrain_autoencoders(embed, state, dat, 2048,
                                     num_batches(dat, 2048), device)

    for name, (phase, cfg) in method_configs(Config).items():
        ae = cfg.method == "ae"
        dat, bats, bats_cpu = ((ae_data, ae_batches, ae_cpu) if ae
                               else (data, batches, batches_cpu))
        before = graph_launches()
        embed, state, rec = phase_method(build_all, fence, cfg, dat, bats,
                                         KERNELS,
                                         pretrain if ae else None)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        if not rec["graphed"]:
            raise AssertionError(f"{name}: graphed {rec['graphed']}, "
                                 f"{rec['capture_blockers']}")
        if name == "ada_sibling":
            part = next(p for p in embed.parts if type(p).__name__
                        == "AdaPart")
            st = state.embed[f"part{embed.parts.index(part)}"]
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                part._rebuild(st)
                fence(st)
                times.append((time.perf_counter() - t0) * 1e3)
            rec.update(hotn=part.hotn, ids=part.total_n,
                       admitted=int((st["dic"] > 0).sum()),
                       rebuild_ms=float(np.median(times)),
                       rebuild_window_ms=times)
        rec["kernel_cases"] = method_kernel_cases(
            name, rowsum, scatter_add, embed, state, bats[0])
        del embed, state
        torch.cuda.empty_cache()
        gate_cfg = cfg if cfg.method != "cafe" else dataclasses.replace(
            cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0)
        rec["card_vs_cpu"] = gate_card_cpu(
            build_all, from_reference, to_numpy, _bce, gate_cfg, dat, bats,
            bats_cpu, pretrain if ae else None)
        torch.cuda.empty_cache()
        emit({"phase": phase, "config": name, **rec})
    clim = phase_cli_methods(main_torch.main, make_criteo_arrays, KERNELS)
    by_path["cli_qr_dcn"] = clim["launches"]
    emit({"phase": "cli_qr_dcn", **clim})
    skb = phase_sketch_bench(load_tool("sketch_bench_torch"), KERNELS)
    by_path["sketch_bench"] = skb["launches"]
    emit({"phase": "sketch_bench", **skb})

    # ---- the data and experiment tools: preprocessing, the task
    # launcher, the Criteo-scale grid, the interactions splitter
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    tools_root = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir=scratch)
    try:
        t0 = time.perf_counter()
        pre = phase_preprocess_cli(main_torch.main, preprocess, native,
                                   KERNELS, tools_root)
        by_path["preprocess_cli"] = pre["launches"]
        emit({"phase": "preprocess_cli", "wall_s": time.perf_counter() - t0,
              **pre})
        t0 = time.perf_counter()
        emit({"phase": "job_scheduler", **phase_job_scheduler(
            job_scheduler, visualization, os.path.join(tools_root, "py"),
            tools_root), "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        grid = phase_criteo_grid(
            criteo_grid, build_all, from_reference, to_numpy, _bce, land,
            KERNELS, os.path.join(os.path.abspath(OUT_DIR),
                                  "criteo_grid_torch.jsonl"))
        by_path["criteo_grid"] = grid["launches"]
        land_shapes["criteo_grid_cr0.1"] = [grid["land_max_case_cr0.1"]]
        emit({"phase": "criteo_grid", "wall_s": time.perf_counter() - t0,
              **grid})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gri = phase_graphrec_interactions(main_graphrec_torch,
                                          process_interactions, KERNELS,
                                          tools_root)
        by_path["graphrec_interactions"] = gri["launches"]
        in_graphs["graphrec_interactions"] = gri["launches_in_graphs"]
        emit({"phase": "graphrec_interactions",
              "wall_s": time.perf_counter() - t0, **gri})

        # ---- the repo's root measurement tools and a dataset launcher
        tool_phases = (
            ("latency_grid", lambda: phase_latency_grid(
                load_tool("latency_grid_torch"), visualization, scatter_add,
                KERNELS, tools_root)),
            ("step_breakdown", lambda: phase_step_breakdown(
                load_tool("step_breakdown_torch"), KERNELS)),
            ("profile_step", lambda: phase_profile_step(
                load_tool("profile_step_torch"), tools_root, KERNELS)),
            ("profile_train", lambda: phase_profile_train(
                load_tool("profile_train_torch"), KERNELS)),
            ("variance_cafe_vs_hash", lambda: phase_variance(
                load_tool("variance_cafe_vs_hash_torch"), land, KERNELS)),
            ("sweep_cafe_vs_hash", lambda: phase_sweep(
                load_tool("sweep_cafe_vs_hash_torch"), land, KERNELS)),
            ("ab_apply128", lambda: phase_ab_apply128(
                load_tool("ab_apply128_torch"), scatter_add, KERNELS,
                WARMUP_CALLS)),
            ("ab_interact", lambda: phase_ab_interact(
                load_tool("ab_interact_torch"), KERNELS)),
            ("ab_scatter_vs_sorted", lambda: phase_ab_scatter_vs_sorted(
                load_tool("ab_scatter_vs_sorted_torch"), KERNELS)),
            ("reset_cost", lambda: phase_reset_cost(
                load_tool("reset_cost_torch"), KERNELS)),
            ("probes", lambda: phase_probes(
                load_tool("kernel_overhead_probe_torch"),
                load_tool("micro_ops_torch"), load_tool("clock_probe_torch"))),
            ("launcher_criteo_kaggle", lambda: phase_launcher(
                os.path.join(tools_root, "py"), tools_root)))
        scatter_shapes = {}
        for name, phase in tool_phases:
            t0 = time.perf_counter()
            before = graph_launches()
            rec = phase()
            count_in_graphs(name, before)
            gc.collect()
            torch.cuda.empty_cache()
            if "launches" in rec:
                by_path[name] = rec["launches"]
            if "land_max_cases" in rec:
                land_shapes[name] = rec["land_max_cases"]
            for path, case in rec.get("scatter_add_cases", {}).items():
                scatter_shapes[f"{name}_{path}"] = [case]
            emit({"phase": name, "wall_s": time.perf_counter() - t0, **rec})
    finally:
        shutil.rmtree(tools_root, ignore_errors=True)

    # ---- the last root tools: the collective-bytes table and the digest
    t0 = time.perf_counter()
    traffic = phase_traffic_table(load_tool("traffic_table_torch"), land,
                                  KERNELS)
    by_path["traffic_table"] = traffic["launches"]
    land_shapes["traffic_table"] = traffic["land_max_cases"]
    emit({"phase": "traffic_table", "wall_s": time.perf_counter() - t0,
          **traffic})
    t0 = time.perf_counter()
    before = graph_launches()
    bt = phase_bench_torch(load_root("bench_torch"), land, KERNELS,
                           WARMUP_CALLS)
    count_in_graphs("bench_torch", before)
    by_path["bench_torch"] = bt["launches"]
    land_shapes["bench_torch"] = bt["land_max_cases"]
    emit({"phase": "bench_torch", "wall_s": time.perf_counter() - t0, **bt})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit({"phase": "perf_report", **phase_perf_report(
        load_tool("perf_report_torch"), v1_graphed["headline_graph"]),
        "wall_s": time.perf_counter() - t0})

    sources = {"land_max": ("cafe_tpu_torch/kernels/land.cu",
                            "cafe_tpu/ops/pallas_land.py:167",
                            kern["land_max"][0]),
               "scatter_add": ("cafe_tpu_torch/kernels/scatter_add.cu",
                               "cafe_tpu/ops/pallas_apply.py:164",
                               kern["scatter_add"]),
               "rowsum": ("cafe_tpu_torch/kernels/rowsum.cu",
                          "cafe_tpu/ops/pallas_rowsum.py:100",
                          kern["rowsum"]["routed"]),
               "gather": ("cafe_tpu_torch/kernels/gather.cu",
                          "cafe_tpu/ops/pallas_gather.py:67",
                          kern["gather"]["decision4"]),
               "a2a": ("cafe_tpu_torch/kernels/a2a.cu",
                       "cafe_tpu/ops/pallas_a2a.py:126",
                       kern["a2a"]["n1"]["rows"])}
    lines = []
    for name, (src, replaces, rec) in sources.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        graphed = {path: counts[name] for path, counts in in_graphs.items()
                   if counts[name]}
        lines.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "launches_in_graphs": sum(graphed.values()),
            "launches_in_graphs_by_path": graphed,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "graph_ms": rec.get("graph_ms"),
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "launches_in_bodies": KERNELS[name].body_launches})
    # K1 also at the shapes the graph recommenders', the grid's and the
    # CAFE-vs-hash tools' inserts give it; K2 at the latency grid's and
    # ab_apply128's
    lines[0]["other_paths"] = land_shapes
    lines[1]["other_paths"] = scatter_shapes
    # K3 at the shapes the graph recommenders' sums give it
    # (ops/sparse.segment_rows), with each path's launches in and out
    # of graphs
    lines[2]["other_paths"] = {
        path: {"cases": cases, "launches": by_path[path]["rowsum"],
               "launches_in_graphs": in_graphs[path]["rowsum"]}
        for path, cases in rowsum_shapes.items()}
    if not all(v["launches_in_graphs"]
               for v in lines[2]["other_paths"].values()):
        raise AssertionError("K3 launched in no graph recommender's graph")
    # K5's device all-gather and reduce-scatter (the branch bodies' rare
    # legs) at n = 1
    lines[4]["collectives"] = kern["a2a"]["n1_collectives"]
    # the mesh's steps replay graphs: K5 must have run inside them
    if not lines[4]["launches_in_graphs"]:
        raise AssertionError("K5 launched in no CUDA graph replay")
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
