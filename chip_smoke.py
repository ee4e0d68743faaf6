"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. Device: a CUDA GPU must be present; prints its name and the
   ``nvidia-smi`` name and power limit.
2. Build: compiles K1, K2, K2b, K3, K3t, K4, K5, K6, K7, K8, K9, K10,
   K11, K12, K13, K14, K15, K16 and K17 (kernels/csrc/megakernel.cu,
   megakernel_clustered.cu, intersect.cu, bvh_walk.cu, rng_rays.cu,
   wavefront_pass.cu, dense_hit.cu, replay.cu and gather_rows.cu, one
   nvcc a source, all at once) for
   sm_90a; prints ptxas's registers and spills of every kernel, each on a
   line of its own.
3. K1 vs plain: K1 and its plain PyTorch version on the same card and
   inputs, on four small presets and at the main path's full size:
   radiance sums and segments bit-equal (the image bound,
   ``(|a - b| > 1e-3).mean() < 0.01`` on per-pixel mean radiance, and
   segment totals within 0.1% are logged beside).
4. The render path: ``render_image_mega`` on the final scene (1200x800 @ 10
   spp, depth 50, seed 0), launch counter reset before and read after,
   radiance sum within 1% of ``bench_golden.json``; median of 3 timed runs
   after a warm run; the image goes to ``out/final_torch.png``.  K1's warp
   lane efficiency (segments over 32 x its warps' steps), beside that of a
   warp whose lanes each trace one pixel's samples in turn.
5. K2 and K2b vs plain on the four small presets: K2's radiance and
   segments bit-equal to K1's, K2's and K2b's tapes and K2b's trip counts
   bit-equal to the plain versions', K2b's tape equal to K2's and its
   per-ray trip counts summing to K1's segments; K2's path,
   ``render_pixels_mega(emit_tape=True)`` over the full frame, with its
   launch counter reset before and read after; a 512-ray slice at ray id
   9.5 M of the final scene through K2 and K2b equal to the same columns of
   the full-frame K2 tape and to the plain K2b's; K2b over the whole frame
   (9.6 M ray ids, far past the card's resident lanes, so its warps take
   many windows of ids each): its tape bit-equal to the full-frame K2
   tape, its trips per pixel to phase 3's K1 segments (held there to the
   plain version), its last 2^17 columns and trips bit-equal to the plain
   K2b's, its warp lane efficiency (trips over 32 x its warps' steps)
   logged; K1, K2 and K2b timed at full frame, in turns.
6. The differentiable path at full width (bench.py's grad configuration):
   the final scene, ray ids [0, 2^17), zero target, mean squared radiance,
   every DIFF_FIELDS leaf.  Counters reset, then one step (record by K2b,
   ``plan_buckets``, ``render_loss_and_grads_bucketed``) and the step's
   segment count (K2b's per-ray trip counts, bench.py's instrumentation
   pass), counters read.  Checks at that size: K2's and K2b's tapes equal,
   each bit-equal to its plain version, K2's radiance and segments
   bit-equal to the plain K2's, K2b's trips to the plain K2b's and, per
   pixel, to K2's segments; K2's tape against the plain wavefront
   ``record_paths`` (above 0.999); the replay's radiance per pixel against
   K1 over the 13,107 whole pixels (the image bound); finite loss and
   gradients, a non-zero albedo gradient.  Against the JAX package's golden
   (``first_raytracer_tpu_torch/data/grad_golden_final_2p17.json``, with
   JAX's tape beside it): K2's tape agrees with JAX's above 0.999; in
   float32, on K2's tape and on JAX's, the loss within 1% and the albedo
   gradient's relative L2 error within 5%, and the loss on JAX's tape
   within the golden's spread between JAX's two float32 programs (3.7e-4)
   of JAX's forward replay of that tape; in float64, the port's replay of
   JAX's tape against JAX's float64 replay: the loss and every gradient
   within 1e-6, those that rest on near-tangent rays (``TANGENT_FIELDS``)
   within 1e-2.  On the card ``render_loss_and_grads_bucketed`` replays a
   CUDA graph of its body, so every check above holds the graphed step;
   ``graph_against_eager`` then holds it to its eager body
   (``bucketed_loss_and_grads``) on the same inputs, for two keys and
   after an Adam step has moved the parameters: the loss within one
   float32 ulp, every gradient within ``rtol=1e-6``.  Times: K2, K2b and
   their plain versions at 2^17 rays; the eager and the graphed value and
   gradient and whole step, in turns (median of 3); the latest capture's
   warm-up and capture seconds and pool bytes; peak memory of the
   capturing step and of an eager and a graphed step; K2b's warp lane
   efficiency at 2^17 rays.
7. ``python -m first_raytracer_tpu_torch.cli fit ... --fast`` in a
   subprocess on the card: exits 0, the loss falls, K2b launched each step,
   every step replayed the graph (its captures against replays logged).
   Then ``cli fit`` without ``--fast`` (the direct step, every step's
   recorder loop and whole-tape value and gradient replayed as CUDA
   graphs): exits 0, the loss falls, the replay's graph replayed on each
   of the 5 steps and the recorder's loop captured once and replayed on
   the target's recording and on every step.
8. K3 vs plain on small scenes: three-spheres, random-spheres and
   triangle-mesh at 64x32, sphere_field(600) and triangle_field(2000) at
   64x32 @ 2: radiance and segments bit-equal to the plain version (the
   image bound and segment totals logged beside), and K3's sweep counters
   at or below an ungated sweep's; K1 and K3 timed on each (the small
   scenes of the ``DENSE_MAX`` crossover).  K3 against K1 at full size on
   field5000 (800x450 @ 4) and on the final scene (1200x800 @ 10): the
   image bound, both kernels timed; the final scene's radiance sum within
   1% of its golden.
9. The large-scene render path: ``render_image_mega_clustered`` on
   field20000, field5000 and trifield20000 at 800x450 @ 4, seed 0, launch
   counter reset before and read after (one K3 launch per frame), each
   radiance sum within 1% of the C++ oracle's golden of the same frame
   (``first_raytracer_tpu_torch/data/field_goldens_oracle.json``), logged
   beside ``bench_golden.json``'s TPU golden with its offset; seconds per
   frame (median of 3 after a warm run), Mpaths/s, Mrays/s, the host pack's
   seconds, K3's CUDA-event ms, the clusters its lanes opened per segment
   and the clusters each warp swept per step (its union: each opened
   cluster once, however many lanes needed it).  At that shape K3's output
   is held against its plain version on the middle quarter of the frame's
   pixels (the image bound; segment totals within 0.1%, per pixel on
   trifield20000; the pixels that differ at all are counted, and on
   trifield20000 none may: there K3 is bit-equal), and the plain version
   is timed there.
10. K3t and the clustered fit step: K3t's tape against the plain version
   on the small presets of phase 8 (agreement above 0.999, 0.99 on
   triangle scenes); on ray ids [0, 2^17) of field5000 against K2b's tape
   (above 0.999, rays that differ counted) and its plain version, and on
   field20000 against its plain version (above 0.999); K3t on both, and
   K2b on field5000, against the plain wavefront ``record_paths`` run in
   float64 at 0.999 or above, the agreement with the same recorder in
   float32 logged beside it (``wavefront_agreement``).  One
   ``make_fit_step_replay`` step on field5000 at 2^17 rays, every
   DIFF_FIELDS leaf, zero target, counters reset before and read after: it
   launches K3t, its loss and gradients are finite, its loss is within
   1e-3 of the loss on K2b's tape and each ray's replayed radiance is
   bit-equal where the two tapes are; K3t's ms and warp lane efficiency
   (trips over 32 x ``sweeps[:, 5]``) on both fields (2^17 rays are past
   its resident lanes, 4 blocks of 128 on each SM), the step's seconds
   (median of 3 after the first) and gradient Mpaths/s.  Then phase 6's
   ``graph_against_eager`` on field5000 with K3t's tapes: the graphed step
   against its eager body for two keys and after an Adam step, and the
   two timed in turns.

11. K4 and K5 against their plain versions: the small scenes of phase 8
   and sphere_field(5000), each on its camera rays and on 4096 random rays
   (uniform origins in [-8, 8]^3, normal directions), K5 on
   ``pack_scene_clustered`` with max_leaf 1, 7 and 128: hit masks and
   primitives equal and t within 1e-6 relative (measured: equal), and K5
   equal to K4.  sphere_field(600), sphere_field(5000) and
   triangle_field(2000) hold more primitives than one of K4's shared-memory
   tiles (512 spheres, 256 triangles), so K4's ring of tiles is held to
   its plain version there; with max_leaf 1 a supergroup of K5 holds 8
   one-slot clusters.
12. The dense wavefront path at full width (K4): the final scene at
   1200x800 @ 10 spp, depth 50, seed 0, through ``render_image`` with
   ``accel=pack_scene_pallas(scene)``, ``mode="regenerative"`` and a pool
   of 2^17 (``bench.py BENCH_MODE=regenerative``), then ``mode="wavefront"``
   in chunks of 2^17, counters reset before each and read after.  Both run
   as CUDA graphs of their loops (``render/graphed.py``): K4's launches
   (the capture's, added back on every replay) equal the passes replayed
   plus the warm-up's block; the host reads the alive flag once per
   ``PASSES_PER_READ`` passes, with fewer than that many inert passes a
   loop; the captures, replays and a capture's seconds and pool bytes are
   logged.  Each radiance sum within 1% of the golden, the two images equal
   to 2e-6.  Each graphed frame ``torch.equal`` to the eager one
   (``graphed=False``, K4's calls clocked by events), radiance and
   segments ray by ray.  On ray ids [0, 2^17): K4 and its plain version
   give equal radiance and segments, the dense sweep (another summation
   order) the image bound and segment totals within 0.1%; a
   ``record_paths_pool`` tape through K4 agrees with K2b's and with the
   plain wavefront ``record_paths`` on the dense sweep at 0.999 or above,
   and equals the plain ``record_paths`` on K4's plain version.  K1's image
   of the frame is compared and logged.  Times: seconds per frame through
   ``render_image``, eager / graphed / graphed / eager (each frame
   ``torch.equal`` to the first graphed one; the pool's median of 3 a
   turn, the chunked frame one frame a turn: an eager one takes ~18 s),
   Mpaths/s, Mrays/s; K4's launches and bound, its ms at 2^17 camera rays
   (20 calls captured in a CUDA graph, whose replays are timed: one eager
   call costs the host more than the kernel takes), and per frame: the
   regenerative frame's batches replayed back to back in a graph, and the
   sum of events around each eager call.
13. The clustered wavefront path at full width (K5): field20000 and
   trifield20000 at 800x450 @ 4, depth 50, seed 0, through ``render_image``
   with ``accel=pack_scene_clustered(scene)``, wavefront in chunks of 2^17,
   graphed, counters reset before and read after (K5's launches and the
   reads held as in phase 12), each graphed frame ``torch.equal`` to the
   eager one (per pixel, and its segments).  The same frame through K4
   gives the image bound (pixels that differ at all are counted) and
   segment totals within 0.1% (per pixel on trifield20000).  Each radiance
   sum within 1% of the oracle's golden, as in phase 9.  At 2^17 camera
   rays, K5 and K4 each equal their plain versions (hits, primitives and
   t) and each other: K4's tiled path at full width.  Times: seconds per
   frame eager / graphed / graphed / eager (median of 3 a turn), Mpaths/s,
   Mrays/s, the host pack's seconds, K5's launches, ms (as K4's) and bound
   from its per-ray counters.

14. The sharded megakernels in this process, under a world-size-1 NCCL
   process group that the phase opens (so their all-gather runs through
   NCCL on the card): ``render_image_mega_sharded`` on the final scene
   bit-equal to phase 4's frame, ``render_image_mega_clustered_sharded``
   on field20000 bit-equal to phase 9's, each with one K1 or K3 launch
   (counters reset before, read after), timed (median of 3 after a warm
   run) beside the all-gather of its pixels alone.  K3 over 4 pixel ranges
   of field5000 and of trifield20000 (4 launches each), concatenated,
   bit-equal to the whole-frame K3; the second range against the plain
   version's same range: on field5000 phase 9's bounds (K3's gate parts
   from the ungated plain version on a few grazing hits; the pixels that
   differ are counted), on trifield20000 bit-equal.
15. Two processes on the one card: ``python -m
   first_raytracer_tpu_torch.parallel.dryrun --size chip`` as ranks 0 and
   1 of a gloo group over a localhost store (NCCL refuses two ranks on
   one GPU; the collectives stage through host tensors, logged as such,
   while the compute stays on the card).  Each rank's
   ``render_image_mega_sharded`` of the final scene is bit-equal to phase
   4's frame and its ``render_image_mega_clustered_sharded`` of field20000
   to phase 9's (both timed, with the all-gather's share); the wavefront
   ``render_image_distributed`` with K4 on random-spheres 120x80 @ 4 is
   bit-equal to one process's ``render_image`` with pixels split (2 x 1)
   and within the image bound with samples split (1 x 2);
   ``render_image_ring`` on random-spheres 64x32 @ 2 is within the image
   bound of the replicated render and selects the replicated sweep's
   primitive for every camera ray; the sharded record->replay step at
   2^17 rays of the final scene (2^16 a rank, each recorded by K2b) has
   the ranks' tapes equal to phase 6's and its loss and gradients within
   ``rtol=1e-4, atol=1e-7`` of phase 6's step (each rank replays its own
   graph of the value and gradient, the all-reduce outside it); the
   training step, the sharded direct step
   (``render_loss_and_grads_sharded``: each rank records its block of
   2^16 of the final scene's first 2^17 rays at depth 50 and replays its
   graph of the value and gradient over the whole batch's count, the
   fields of JAX's ``train_step``), has the ranks' tapes concatenated
   ``torch.equal`` to one process's and its loss and gradients within the
   same bound of one process's direct step; each rank's training step is
   timed op by op and graphed (median of 3 after a warm run).  K1, K3, K4
   and K2b must each launch on every rank, and each rank's replay and
   training steps must replay their graphs.  A rank that fails fails the
   phase.
16. ``python -m first_raytracer_tpu_torch.cli occupancy`` in subprocesses:
   on the final scene at full size its megakernel ``lane_occupancy``
   within 1e-3 of phase 4's lane efficiency (the warps' steps follow the
   schedule) and its ``mean_path_len`` phase 4's segments over rays; on
   three-spheres 24x12 @ 2 (the JAX package's own case) both megakernels'
   ``mean_path_len`` within 1e-3 of the wavefront's ``avg_path_length``
   over the same rays; over the final scene's whole full-size frame, phase
   4's segments against ``wavefront_occupancy`` on K4 over the same rays
   (its scan the recorder's loop replayed as CUDA graphs, as in the CLI),
   the mean path length within 1e-3 (each side's paths at the depth cap
   logged).  The same comparison at 64x32 @ 8 (2^14 rays) is logged.
17. ``python3 bench_torch.py`` in subprocesses (``BENCH_RUNS``): ``mega``
   on the final scene (K1); ``megacluster`` on field20000, field5000 and
   trifield20000 (K3, checked against the oracle's goldens); ``grad`` on
   the final scene (K2b) and on field5000 (K3t), 4 steps back to back;
   ``regenerative`` on the final scene (K4, and K6 with
   ``BENCH_INTERSECT=bvh``); ``wavefront`` on field20000
   with ``BENCH_INTERSECT=clustered`` (K5).  Each exits 0 with one JSON
   line without an ``error``, its guards passed, and its ``launches`` show
   its kernel; each value is logged beside the earlier phase's reading of
   the same configuration.
18. The direct gradient step (``cli fit`` without ``--fast``; the JAX
   package's jitted ``render_loss_and_grads``) at 2^17 rays of the final
   scene (dense sweep, depth 50, ids [0, 2^17), zero target, every
   field) through ``render_loss_and_grads`` (the lockstep recorder's loop
   and the whole tape's value and gradient replayed as CUDA graphs),
   after the same step op by op (``graphed=False`` and the eager body
   ``tape_loss_and_grads``): the tapes ``torch.equal``, the loss within
   one float32 ulp, the gradients within ``rtol=1e-6``; the recorder's
   flag read once per ``PASSES_PER_READ`` passes.  Against the JAX golden
   (its recorder is this lockstep ``record_paths``): the tape's
   agreement above 0.999 and its hits per row beside the golden's (the
   differences logged), the loss within 1% and the albedo gradient within
   5%.  Eager, graphed, graphed, eager: the step, the recorder and the
   replay; the captures' seconds and pool bytes, peak memory.  The pool
   recorder (2^14 slots) equals the lockstep one.  The same step through
   K4 (counters reset before, read after: its launches go to the kernels
   line), its tape at 0.999 or above of the dense sweep's and its pool
   recorder's equal; field5000 through K5, graphed against eager as
   above, its tape's agreement with K3t's logged, timed in turns.
19. K6, the flat-BVH walk (``intersect_bvh`` on a ``FlatBVH``), on the
   graft entry's BVH (the final scene, ``build_bvh(max_leaf=4)``): bit-equal
   (prim, t, hit) to its plain version, the lockstep walk, and with the
   same per-ray counters (nodes, sphere slots, triangle slots: the same
   visits), through the path each scene takes (shared memory when its
   node records and leaf slots fit ``traverse.SHARED_BUDGET``, else
   global), on the final scene's 2^17 camera rays and on one bounce's
   secondary rays from their hits, on field5000's, field20000's and
   trifield20000's 2^17 camera rays (global), on trifield20000's
   triangles alone and on the triangle-mesh preset's (triangles and
   spheres); each set also through the other path forced where a block
   can hold the staged bytes (the final scene's and triangle-mesh's
   global, field5000's shared), each set of 2^17 rays timed through each
   (20 calls in a CUDA graph) beside its bound; ``build_bvh`` of the final
   scene and the three fields, native and NumPy, timed on the host.
   Against the dense sweep on the 2^17 camera rays, the same hits and
   primitives but
   on exact ties in t (counted); no host sync inside its call
   (``torch.cuda.set_sync_debug_mode``; the plain walk's logged).
   ``entry()``'s forward (the graft entry's step) graphed twice, each
   ``torch.equal`` to the same forward op by op through the plain walk
   (``graphed=False``), both timed.  The lockstep recorder through K6 at
   2^17 rays against phase 18's dense-sweep tape (above 0.999, the
   differing entries counted).  The main path: the final scene's full
   frame (1200x800 @ 10, depth 50) through ``render_image``'s
   regenerative pool of 2^17 on K6, graphed, counters reset before and
   read after (K6 launched once a pass), its radiance sum within 1% of
   ``bench_golden.json``; the same frame through K4 beside it (the image
   difference logged), both timed in turns; the same pool op by op
   (``graphed=False``, K6 clocked by events) ``torch.equal`` to the
   graphed one.  K6's ms at 2^17 camera rays (in a CUDA graph) and over
   the frame's calls, its bound from its counters (25 operations a node,
   20 a sphere slot, 52 a triangle slot), the plain walk's ms.  Then
   ``cli render --mode regenerative --bvh`` at 120x80 @ 4 in a
   subprocess: it exits 0 and its line shows the loops captured and
   replayed.
20. K7 and K8, the Threefry draw (``core.rng.uniforms``) and camera rays
   (``render.camera.camera_rays``) of the replays and the recorders' and
   the wavefront loops' inits.  The main path, counters reset before and
   read after each run: the pool recorder (2^14 slots) over 2^17 rays of
   the final scene through K4, graphed: K8 once for the init (and once a
   warm-up), K7 never (its passes draw inside K12 and K13, phase 22), its
   tape ``torch.equal`` to the same recorder op by op; the graphed replay
   of its tape: K8 once, K7 never (it draws inside K14 and K15, phase 23),
   K14 and K15 once each; K7's own path since then, the differentiable
   scan (``method="scan"``, ``scan_path``) at 2^17 rays of the final
   scene, depth 50, every DIFF_FIELDS leaf, zero target, a replay of its
   captured graph (``dg.SCAN_GRAPHS``; warm-up and capture seconds, pool
   bytes, peak memory): K8 once, K7, K11 and K16 once a trip, K17 once a
   trip but the last (whose rows reach no output), every K11 launch given
   the liveness mask; the graph against the eager body
   (``scan_loss_and_grads``; the loss within one float32 ulp, gradients
   within ``rtol=1e-6``) and against phase 18's replay step on the same
   rays (loss ``rtol=1e-6``, gradients ``rtol=2e-3, atol=1e-7``:
   ``test_replay_matches_scan``'s bounds); the eager body bit-equal in the
   loss and every field to the same body whose closest hit takes five
   arguments (K11 sweeping every ray, so dead rays read other rows: K17's
   sum does not move); the eager body's kernels by device time
   (``torch.profiler``, the top 8 logged), none of them torch's
   ``indexing_backward_kernel``; eager and graphed in turns
   (eager, graphed, graphed, eager) with each one's peak memory.  Bit-equal to
   their plain versions
   (``rng.uniforms_plain``, ``camera.camera_rays_plain``: torch ops) on the
   card: K7's camera draw at 2^17 final-scene ids, its bounce draw at a
   0-d depth, at per-ray depths 0-50 and at the ids and depths of the
   pool frame's last pass (the frame run op by op); K8 at 2^17 ids, at the
   last pass's ids, with a float64 camera, on camera-effects' lens, at ids
   on both sides of 2^32 - 1 (its 32-bit decode and its int64 one) and on
   the last chunk of a frame at the default chunk, padded with its last
   id.  Times at 32, 1024, 2^15 and 2^17 rays, each kernel's 20 calls in a
   CUDA graph beside a graph of 20 one-element fills (a launch's floor),
   the plain versions at 2^17, one call a graph and one eager call; bounds
   and the term that binds them from ``utils/roofline.py``.
21. K9 and K10, the wavefront pass's shading and compaction and the pool's
   regeneration (``render.wavefront_pass``).  Pass by pass, ``torch.equal``
   to their plain versions (``shade_plain``, ``regenerate_plain``: torch
   ops) on the card, every tensor of the state (the pool compacted in
   place, the slots past its survivors, output rows, segment counts, the
   cursor and the pass record), K9's scan words checked on their own
   (every tile's word this pass's inclusive prefix) and carried from pass
   to pass: a pool of 2^17 slots over 2^19 ray ids from id 1000 and the
   trips of a chunk of 2^17 ids, on the final scene through K4 and
   through K6, field20000 and trifield20000 through K5, triangle-mesh,
   its triangles alone and camera-effects through the dense sweep; and a
   stress set, a pool of 2^21 slots (8192 blocks of K9, several waves on
   the card, so that look-backs wait) over 2^22 ids of the final scene
   through K4.  The main path, counters reset before and read after each:
   the final scene's pool frame through K4, graphed (K9 and K10 once a
   pass, K7 not at all, K8 once for the init, the radiance sum within 1%
   of ``bench_golden.json``), its chunked frame (K9 once a trip, K10 not
   at all), and field20000's and trifield20000's chunked frames through
   K5 (within 1% of their oracle goldens).  Times at 2^17 slots, 20 calls
   a CUDA graph: K9 in pool mode (the pass's state restored before each
   call, the restore's own time taken off) and in trip mode (a chunk's
   first trip, its carry restored likewise), K10 (the tail's camera rays
   and the cursor), and the plain versions one call a graph, each beside
   its time before the redesign (``EARLIER_K9``); bounds from
   ``utils/roofline.py``, from this run's live, missing and continuing
   slots.  A graphed pool pass's and trip's ms and nodes
   (``cuGraphGetNodes``, at most 4 each) beside the 5 and 4 before the
   redesign and the 267 and 259 before K9 and K10.  Phases 12, 13 and
   19's graphed frames are printed beside those before the redesign and
   before K9 and K10 (``EARLIER``).

22. K11, K12 and K13, the recorders on the device (``kernels.dense_hit``,
   ``diff.record_pass``).  K11 against ``intersect_brute``, (prim, t, hit)
   ``torch.equal``, on the final scene's 2^17 camera rays and its first
   bounce's rays, 2^16 camera rays of field5000, field20000 and
   trifield20000, and two tie sets (the final scene with every sphere
   twice; rays down the shared edge of two triangles, each twice), each
   also with liveness masks of live shares 1, 0.5, 0.1, 0.03, 0.01, 0.001
   and 0 (from a numpy seed) against ``dense_hit_plain`` (the masked
   plain sweep) on every ray, and the first bounce's recorder state with
   its own mask; K11's ms at 100%, 10% and 1% live.  K12 in
   lockstep and length modes bounce by bounce (2^16 rays, the counter
   after every bounce), and K12's pool launch with K13 folded in pass by
   pass (2^14 slots over the same ids, its scan words checked and
   carried), ``torch.equal`` to ``record_step_plain`` and to
   ``record_shade_plain`` then ``record_regenerate_plain`` (the flat
   tape's last entry aside) on phase 21's seven sets.  The main path,
   counters reset before and read after each: the direct step at 2^17
   rays of the final scene (K11 and K12 once a bounce), the lockstep and
   the pool recorder (2^14 slots: K11 and K12's pool launch, which counts
   K13 too, once a pass), their tapes ``torch.equal`` to the same
   recorders on the plain versions op by op and to each other, and the
   occupancy scan of 2^17 rays (K11 and K12's length mode), its counts
   equal to the plain route's.  Times (20 calls a CUDA graph, the state a
   call changes restored and its time taken off): K11 on the 2^17 camera
   rays; K12 at their first bounce in lockstep and length modes at live
   shares 1, 0.1 and 0.01 (each bit-equal to the plain seam), summed over
   the direct step's bounces, and its pool launch after a pass at 2^14
   and 2^17 slots; the plain versions one call a graph; bounds from
   ``utils/roofline.py``.  A graphed lockstep bounce's, pool pass's and
   length pass's ms and nodes (``cuGraphGetNodes``, at most 2 each), and
   the graphed direct
   step, recorders and field5000's direct step twice each after a warm
   call, beside their times before K11-K13 (``EARLIER_K12``).  The
   final scene's pool frame (2^17 slots) and chunked frame (chunks of
   2^17) without an accel, graphed, counters reset before and read after
   each (K11 once a pass, with the pool's or the chunk's mask), their
   radiance sums within 1% of ``bench_golden.json``, and their seconds
   twice after that first frame.
23. K14 and K15, the tape replay's value and gradient
   (``diff.replay_pass``).  On 2^17 camera rays of the final scene, on
   K2b's tape and on JAX's golden tape, and of field5000 on K3t's: K14's
   float32 radiance ``torch.equal`` to the plain loop's
   (``replay_plain``, torch ops, on the card) and K15's float64 gradients
   of the mean squared radiance within a relative L2 error of 1e-8 per
   field of the plain loop's autograd (the CPU tests' bound), the float32
   ones logged beside.  The main path, counters reset before and read
   after each: the direct step (K14 and K15 once) and the bucketed step
   (once each a bucket), its gradients finite.  K14 (with and without the
   scratch) and K15 alone, each call in a CUDA graph (median of 5), the
   plain loop's forward and backward eager (median of 3), their bounds
   from this run's rows visited and shaded, rays that add radiance and
   bounces swept back; the whole-tape replay's graph nodes
   (``cuGraphGetNodes``) through the kernels and on the plain loop; the
   graphed replay, the direct step and the bucketed step through the
   kernels in turns with the same bodies graphed on the plain loop
   (``plain_replay``), beside their times before (``EARLIER_REPLAY``).
24. K16 and K17, the differentiable scan's row gathers and their sums
   (``kernels.gather_rows``).  On the scan's real trips (an eager scan's
   ``integrator.gather_rows`` wrapped to keep each trip's tables, indices
   and the gradients of its rows) at 2^17 rays of the final scene (the
   spheres' and materials' tables, every trip with a gradient), the same
   cast to float64 (every fifth trip) and triangle-mesh (spheres,
   triangles and materials: three tables): K16 ``torch.equal`` to
   ``index_select``; K17 bit-equal to ``row_sum_plain`` (torch ops on the
   card) and the same bits over 3 launches, and within its bound of a
   float64 ``index_add_`` (``row_sum_bound``, plus that sum's own error,
   n_row 2^-52 times the sum of magnitudes, plus two units in the last
   place of the table's type).  Times at the first trip (the ground's row
   read by most rays) and the second, in float64 and on triangle-mesh,
   each call in a CUDA graph: K16 beside ``index_select`` (its plain
   version and the library call), K17 beside its plain version, torch's
   indexing backward (``index_put_`` accumulating: the route before K17)
   and ``index_add_`` into float64; bounds from ``utils/roofline.py``
   (bytes: the tables, a ray's index and row or gradient).  K17's path
   on the final scene's tables (shared: a block's table of every entry in
   shared memory) and its resident blocks; K16's and K17's graph nodes a
   call (``cuGraphGetNodes``: K16 one, K17 at most ``MAX_ROW_SUM_NODES``,
   the memset and one kernel); and K17's global path (the first trip with
   its material table padded with rows no ray reads, past the shared
   budget) held and timed as above.  The main
   path's launches are phase 20's scan's.

The last two lines of standard output are a JSON object with the kernels'
measurements (``sharded_launches``: the launches of phases 14 and 15;
``bench_launches``: phase 17's, by run; ``direct_step_launches``: phase
18's, K4 on the final scene and K5 on field5000; K6's ``entry_launches``:
phase 19's ``entry()`` forward; K7's ``launches``: phase 20's
differentiable scan (``scan``: its readings), K8's: its pool recorder's
init, ``frame_launches``:
phase 12's frames; K9's and K10's: phase 21's pool frame,
``frame_launches``: its frames; K11's and K12's lockstep mode: phase 22's
direct step, K12's length mode: its occupancy scan, K12's pool mode and
K13, folded into it: its pool recorder; K14's and K15's: phase 23's direct
step, ``bucketed_launches``: its bucketed step; K16's and K17's: phase
20's scan) and
the result line ``{"ok": true, "device": {...}}``.  This
script imports no JAX.  Bounds count FP32 operations from the sources
(``first_raytracer_tpu_torch/utils/roofline.py``, which ``bench_torch.py``'s
plausibility guard counts with too): 20
per (segment, sphere) and 46 per (segment, triangle) for the dense sweep;
for K3 and K3t the slots and boxes their sweep counters say they tested, 29
operations per box test (``gate`` in kernels/csrc/megakernel_clustered.cu).
K4 and K5 (kernels/csrc/intersect.cu) test a sphere in 16 operations (the
oc-form quadratic on (cx, cy, cz, r*r)) and a triangle in 46 (on its
edges, computed once per triangle); K5 adds 29 per box, supergroup or
cluster, its counters say it tested.  K6 (kernels/csrc/bvh_walk.cu) counts
25 per node, 20 per sphere slot and 52 per triangle slot its counters say
it tested.  K7 and K8 (kernels/csrc/rng_rays.cu) count 164 integer
operations a ray at the INT32 rate (and 8 and 71 FP32); K9 and K10
(kernels/csrc/wavefront_pass.cu) add the shading's 60 FP32 operations a
live slot and a tail slot's camera ray, and are bound by their bytes: K9
every slot's state and closest hit read, a survivor's next state written
to its compacted slot, the scan's status words, ticket and pass record;
K10 a tail slot's state written.  K11 (kernels/csrc/dense_hit.cu) counts
K4's 16 a (ray, sphere) and 46 a (ray, triangle) pair; K12 and K13
(wavefront_pass.cu) count K9's and K10's operations and the bytes their
inputs need (a dead ray's liveness byte, a live one's state); K14 and K15
(replay.cu) count K9's draw and shading a shaded bounce (and K15 120
operations of its adjoint) and the bytes of the rays, tape entries,
scratch rows and tables they read and write; K16 and K17
(gather_rows.cu) the bytes of the tables, a ray's index and its row or
gradient.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from first_raytracer_tpu_torch.accel import traverse
from first_raytracer_tpu_torch.accel.build import build_bvh
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as dg
from first_raytracer_tpu_torch.diff import record_pass as rpass
from first_raytracer_tpu_torch.diff import replay as rrep
from first_raytracer_tpu_torch.diff import replay_pass as rreplay
from first_raytracer_tpu_torch.diff.replay import (plan_buckets,
                                                   record_paths,
                                                   record_paths_pool,
                                                   trace_rays_replay)
from first_raytracer_tpu_torch.kernels import dense_hit as dh
from first_raytracer_tpu_torch.kernels import gather_rows as gr
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels import record_mega as rm
from first_raytracer_tpu_torch.parallel import dryrun
from first_raytracer_tpu_torch.parallel.mesh import (TILE_AXIS,
                                                     make_render_mesh)
from first_raytracer_tpu_torch.render import graphed
from first_raytracer_tpu_torch.render import wavefront_pass as wp
from first_raytracer_tpu_torch.render.api import (DEFAULT_CHUNK,
                                                  batch_state,
                                                  render_image,
                                                  render_ray_batch)
from first_raytracer_tpu_torch.render import camera as rcam
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.entry import entry
from first_raytracer_tpu_torch.materials.scatter import scatter
from first_raytracer_tpu_torch.render import integrator as tint
from first_raytracer_tpu_torch.render.integrator import (default_intersect,
                                                         intersect_brute,
                                                         recompute_hit, trip)
from first_raytracer_tpu_torch.render.regenerative import (
    pool_pass, pool_state, render_rays_regenerative)
from first_raytracer_tpu_torch.render.image import write_png
from first_raytracer_tpu_torch.scene.builders import (build_preset,
                                                      random_scene)
from first_raytracer_tpu_torch.utils import metrics
from first_raytracer_tpu_torch.utils.metrics import wavefront_occupancy
from first_raytracer_tpu_torch.utils.roofline import (bound,
                                                      clustered_bound,
                                                      k4_bound, k5_bound,
                                                      k6_bound, k7_bound,
                                                      k8_bound, k9_bound,
                                                      k10_bound, k11_bound,
                                                      k12_bound, k14_bound,
                                                      k15_bound,
                                                      gather_rows_bound)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_KEY = "radiance_sum_mega_1200x800_10spp"
GRAD_GOLDEN = os.path.join(ROOT, "first_raytracer_tpu_torch", "data",
                           "grad_golden_final_2p17.json")
GRAD_GOLDEN_TAPE = GRAD_GOLDEN.replace(".json", "_tape.npz")
SMALL_CASES = [
    ("three-spheres", dict(nx=64, ny=32, spp=4)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("camera-effects", dict(nx=64, ny=32, spp=4)),
    ("random-spheres", dict(nx=96, ny=64, spp=2)),
]
GRAD_RAYS = 1 << 17
SLICE_RAY0, SLICE_RAYS = 9_500_000, 512
# Each kernel's entry in the library (a part of its mangled name).
KERNEL_ENTRIES = (("mega_kernelILb0", "K1"), ("mega_kernelILb1", "K2"),
                  ("record_kernel", "K2b"), ("mega_clustered_kernel", "K3"),
                  ("record_clustered_kernel", "K3t"),
                  ("intersect_dense_kernel", "K4"),
                  ("intersect_clustered_kernel", "K5"),
                  ("bvh_walk_kernel", "K6"), ("uniforms_kernel", "K7"),
                  ("camera_rays_kernel", "K8"),
                  ("shade_pool_kernel", "K9 (pool)"),
                  ("shade_trip_kernel", "K9 (trip)"),
                  ("regenerate_kernel", "K10"),
                  ("dense_hit_kernel", "K11"),
                  ("record_step_kernel", "K12 (lockstep, length)"),
                  ("record_pool_kernel", "K12 (pool) and K13"),
                  ("replay_forward_kernel", "K14"),
                  ("replay_backward_kernel", "K15"),
                  ("replay_order_kernel", "K15 (its order)"),
                  ("row_tile_kernel", "K16"),
                  ("row_gather_kernel", "K16 (int64 path)"),
                  ("row_sum_kernelIfLb1", "K17 (shared path)"),
                  ("row_sum_kernelIdLb1", "K17 (shared path)"),
                  ("row_sum_kernelIfLb0", "K17 (global path)"),
                  ("row_sum_kernelIdLb0", "K17 (global path)"),
                  ("round_kernel", "K15 (its rounding)"))
# Phases 12 and 13: the pool and the chunk of the wavefront renders.
WAVE_RAYS = 1 << 17
# Phase 20: K7 and K8 timed at these ray counts beside a launch's floor.
RNG_RAYS_SIZES = (32, 1024, 1 << 15, 1 << 17)
# Phases 8 and 10: the small scenes.
CLUSTER_CASES = [
    ("three-spheres", dict(nx=64, ny=32, spp=2)),
    ("random-spheres", dict(nx=64, ny=32, spp=2)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("sphere-field", dict(n=600, nx=64, ny=32, spp=2)),
    ("triangle-field", dict(n=2000, nx=64, ny=32, spp=2)),
]
# (ray, column) pairs per chunk of the plain K3 over a whole field frame:
# 1 GiB per float32 temporary (2 per float64 one), so that its launches are
# few and its memory stays a fraction of the card's.
PLAIN_PAIRS = 1 << 28
# Phases 9 and 13: the field frames, held within 1% (bench.py's bound) of
# the C++ oracle's radiance sums (python -m
# first_raytracer_tpu_torch.oracle.native_oracle --write-goldens), each
# logged beside the TPU golden of bench.py's BENCH_MODE=megacluster run of
# the same frame, which carries the expanded sphere quadratic's re-hits.
ORACLE_GOLDENS = os.path.join(ROOT, "first_raytracer_tpu_torch", "data",
                              "field_goldens_oracle.json")
FIELD_SCENES = [
    ("field20000", "sphere-field", 20000,
     "radiance_sum_megacluster_field20000_800x450_4spp"),
    ("field5000", "sphere-field", 5000,
     "radiance_sum_megacluster_field5000_800x450_4spp"),
    ("trifield20000", "triangle-field", 20000,
     "radiance_sum_megacluster_trifield20000_800x450_4spp"),
]


# Phase 17: ``bench_torch.py``'s configurations, each in a subprocess:
# (label, switches, the kernel it must launch).  The grad steps are timed
# 4 back to back (the bench's default is 16) to keep the run short.  The
# final scene's wavefront frame (about 20 s a frame) is left to a manual
# run (README.md).
BENCH_RUNS = [
    ("mega final scene", {}, "K1"),
    ("megacluster field20000", {"BENCH_SCENE": "field20000",
                                "BENCH_MODE": "megacluster"}, "K3"),
    ("megacluster field5000", {"BENCH_SCENE": "field5000",
                               "BENCH_MODE": "megacluster"}, "K3"),
    ("megacluster trifield20000", {"BENCH_SCENE": "trifield20000",
                                   "BENCH_MODE": "megacluster"}, "K3"),
    ("grad final scene", {"BENCH_MODE": "grad",
                          "BENCH_GRAD_PIPELINE": "4"}, "K2b"),
    ("grad field5000", {"BENCH_SCENE": "field5000", "BENCH_MODE": "grad",
                        "BENCH_GRAD_PIPELINE": "4"}, "K3t"),
    ("regenerative final scene", {"BENCH_MODE": "regenerative"}, "K4"),
    ("regenerative final scene, BVH", {"BENCH_MODE": "regenerative",
                                       "BENCH_INTERSECT": "bvh"}, "K6"),
    ("wavefront field20000", {"BENCH_SCENE": "field20000",
                              "BENCH_MODE": "wavefront",
                              "BENCH_INTERSECT": "clustered"}, "K5"),
]
# The graphed wavefront frames and steps before K9 and K10 took the pass's
# shading and regeneration (PERF.md sections 5 and 6: this script's runs in
# PRs 15 and 16 on an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside
# this run's.
EARLIER = {
    "regenerative": "0.155-0.180 s/frame",
    "wavefront": "1.705-1.762 s/frame",
    "field20000": "0.3124-0.3715 s/frame",
    "trifield20000": "0.2702-0.2784 s/frame",
    "pool pass": "0.663-0.678 ms and 267 nodes",
    "trip": "259 nodes (counted on the CPU)",
    "final scene, dense sweep": "graphed step 0.438-0.450 s, recorder "
                                "0.358-0.360 s, replay 0.090 s",
    "field5000, K5": "graphed step 0.121-0.122 s, recorder 0.031 s",
    "pool recorder": "0.0845 s",
    "bvh frame": "0.149-0.173 s/frame, through K4 0.155-0.180",
    "entry": "0.0207-0.0215 s graphed",
    "bvh recorder": "0.0262 s graphed",
}
# K6's times as a one-thread-a-ray kernel, before the warp walk (PERF.md
# section 6: probes/turns.py k6 on that checkout in turns with this one,
# and earlier runs of this script; an NVIDIA H100 80GB HBM3 at 700.00 W),
# printed beside this run's.
EARLIER_K6 = {
    "final scene, 2^17 camera rays": "0.0171-0.0172 ms",
    "final scene, one bounce's secondary rays": "0.0320 ms",
    "field5000, 2^17 camera rays": "0.0233-0.0234 ms",
    "field20000, 2^17 camera rays": "0.0281-0.0284 ms",
    "trifield20000, 2^17 camera rays": "0.0409 ms",
    "frame calls": "9.21-9.29 ms over 234 calls",
    "bvh frame": "0.156-0.178 s/frame",
    "entry": "0.0195-0.0215 s graphed",
}
# Each earlier phase's Mpaths/s of the configuration a bench run repeats,
# by the label of ``BENCH_RUNS``: host clock around the user's entry point,
# the packs (and the gradient step's plan) inside the time.
READINGS = {}


# Gradients of the final scene that rest on a few near-tangent rays, where
# float32 rounding of the sphere discriminant moves them by tens of percent.
TANGENT_FIELDS = ("sphere_center", "sphere_radius", "fuzz", "ref_idx")
# The float64 replay against JAX's: the uniforms stay float32 and go through
# each library's own sine and cosine, and a near-tangent ray magnifies that
# last-bit difference in the fields above (on the CPU at 4096 rays up to
# 8.5e-5 of relative L2 error, tests/test_torch_grad.py); the loss and the
# other gradients agree to about 1e-9 there.
F64_BOUND, F64_TANGENT_BOUND = 1e-6, 1e-2


def to_f64(obj):
    """A copy of a scene or camera with its float tensors in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def compare(rad, segs, ref, ref_segs, spp, what):
    """Kernel vs plain: the image bound and the segment-total bound."""
    a, b = (rad / spp).cpu(), (ref / spp).cpu()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: non-finite kernel radiance")
    diff = (a - b).abs()
    frac = float((diff > 1e-3).float().mean())
    total, ref_total = int(segs.sum()), int(ref_segs.sum())
    seg_rel = abs(total - ref_total) / max(ref_total, 1)
    log(f"  {what}: frac(|a-b|>1e-3)={frac:.6f} "
        f"median={float(diff.median()):.3e} max={float(diff.max()):.6f} "
        f"segments {total} vs {ref_total} (rel {seg_rel:.2e})")
    if not frac < 0.01:
        raise AssertionError(f"{what}: image bound failed ({frac})")
    if not seg_rel <= 1e-3:
        raise AssertionError(f"{what}: segment totals differ ({seg_rel})")
    return float(diff.max())


def compare_clustered(rad, segs, ref, ref_segs, spp, what, per_pixel):
    """K3 vs its plain version: ``compare``'s bounds, or on triangle scenes
    the image bound and segments per pixel (without a dense field of
    spheres, paths leak between coplanar faces and a total moves with one
    of them).  Returns the largest per-pixel error."""
    if not per_pixel:
        return compare(rad, segs, ref, ref_segs, spp, what)
    diff = ((rad - ref) / spp).abs().cpu()
    if not bool(torch.isfinite(rad).all()):
        raise AssertionError(f"{what}: non-finite kernel radiance")
    frac = float((diff > 1e-3).float().mean())
    seg_frac = float((segs != ref_segs).float().mean())
    log(f"  {what}: frac(|a-b|>1e-3)={frac:.6f} max="
        f"{float(diff.max()):.6f}, pixels whose segments differ "
        f"{seg_frac:.6f}")
    if not (frac < 0.01 and seg_frac < 0.01):
        raise AssertionError(f"{what}: K3 off its plain version")
    return float(diff.max())


def cuda_ms(fn, repeats):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, repeats, inner=1):
    """Median milliseconds per call of ``fn``: ``inner`` calls captured in
    one CUDA graph, its replays timed by events.  K4 and K5 take 0.05-0.2
    ms a launch, less than the host's cost of a call of their wrappers, so
    events around eager calls would time the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, repeats) / inner


def host_s(fn):
    """Seconds of ``fn`` and everything it queued on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def final_golden():
    """The final scene's radiance sum in ``bench_golden.json``."""
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        return json.load(f)[GOLDEN_KEY]


def field_golden(what, label, tpu_key, total):
    """Holds a field frame's radiance sum within 1% of the oracle's golden
    and logs its offset from the TPU golden beside it."""
    with open(ORACLE_GOLDENS) as f:
        oracle = json.load(f)["goldens"][label]["radiance_sum"]
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        tpu = json.load(f)[tpu_key]
    rel = (total - oracle) / oracle
    log(f"{what}: radiance sum {total:.3f}, oracle golden {oracle:.3f} (rel "
        f"{rel:+.3e}, bound 1e-2); TPU golden {tpu} (rel "
        f"{(total - tpu) / tpu:+.3e}, logged; the oracle's is "
        f"{(oracle - tpu) / tpu:+.3e} from it)")
    if not abs(rel) < 1e-2:
        raise AssertionError(f"{what}: radiance sum off the oracle's golden "
                             f"by {rel}")


def rel_err(g, w):
    """|g - w| / |w| in float64, or None where ``w`` is zero; and |g|."""
    g, w = g.double().flatten().cpu(), w.double().flatten().cpu()
    if float(w.norm()) == 0.0:
        return None, float(g.norm())
    return float((g - w).norm() / w.norm()), float(g.norm())


def check_grads(what, grads, want, allowed):
    """Each gradient against ``want``'s (a dict of value lists): zero where
    it is zero, else a relative L2 error within ``allowed(field)``."""
    for k, values in want.items():
        err, norm = rel_err(grads[k], torch.tensor(values,
                                                   dtype=torch.float64))
        if err is None:
            ok = norm == 0.0
            log(f"      {what} {k}: reference zero, port norm {norm:.3e}")
        else:
            ok = err <= allowed(k)
            log(f"      {what} {k}: relative error {err:.3e} (bound "
                f"{allowed(k):g})")
        if not ok:
            raise AssertionError(f"{what}: gradient {k} off its reference")


def graph_against_eager(what, scene, cam, cfg, ids, target, record, keys,
                        card):
    """Phases 6 and 10: the graphed value and gradient
    (``render_loss_and_grads_bucketed``, a replay of its captured CUDA
    graph) against its eager body (``bucketed_loss_and_grads``) on the same
    inputs: the loss within one float32 ulp and every gradient within
    ``rtol=1e-6`` (the replay's gather sums its backward in float64 with
    atomics, whose order changes between runs, and then rounds once).  For
    each of ``keys`` (each key's tape recorded by ``record``), then again
    on the first key after an Adam step has moved the parameters.  Then,
    in turns, median of 3: the eager and the graphed value and gradient on
    the first key's tape and the whole step (record, plan, value and
    gradient); the captures' seconds and pool bytes, and peak memory."""
    params, _ = dg.split_params(scene)

    def tape_plan(p, key):
        tape = record(dg.merge_params(scene, {k: v.detach()
                                              for k, v in p.items()}), key)
        return tape, plan_buckets(tape)

    def graphed(p, key, tape, plan):
        return dg.render_loss_and_grads_bucketed(p, scene, cam, cfg, key,
                                                 ids, target, tape,
                                                 plan=plan)

    def eager(p, key, tape, plan):
        return dg.bucketed_loss_and_grads(
            p, scene, cam, key, ids, target, tape, plan[0], cfg=cfg,
            groups=plan[1], num_values=target.numel())

    def hold(label, p, key):
        tape, plan = tape_plan(p, key)
        before = dg.GRAPHS.captures
        loss, grads = graphed(p, key, tape, plan)
        how = "captured" if dg.GRAPHS.captures > before else "replayed"
        want_loss, want = eager(p, key, tape, plan)
        ulp = float(np.spacing(np.float32(abs(float(want_loss)))))
        dl = abs(float(loss) - float(want_loss))
        ratio = max(float(((g - want[k]).abs()
                           / (1e-6 * want[k].abs())).nan_to_num(0.0).max())
                    for k, g in grads.items() if g.numel())
        log(f"  {what}, {label}: graph ({how}, groups {plan[1]}) against "
            f"the eager body: loss {float(loss):.9g} vs "
            f"{float(want_loss):.9g} (|a - b| {dl:.3g}, one ulp {ulp:.3g}); "
            f"gradients' largest |a - b| / (1e-6 |b|) {ratio:.4g} (bound 1)")
        if not (dl <= ulp and ratio <= 1.0):
            raise AssertionError(f"{what}, {label}: the graphed step is off "
                                 f"its eager body")
        return grads

    grads = [hold(f"key {i}", params, key) for i, key in enumerate(keys)]
    opt = dg.make_optimizer("adam", params, 1e-3)
    dg.apply_grads(opt, params, grads[0])
    hold("key 0 after an Adam step", params, keys[0])

    key = keys[0]
    tape, plan = tape_plan(params, key)
    fns = {
        "eager replay": lambda: eager(params, key, tape, plan),
        "graphed replay": lambda: graphed(params, key, tape, plan),
        "eager step": lambda: eager(params, key, *tape_plan(params, key)),
        "graphed step": lambda: graphed(params, key,
                                        *tape_plan(params, key)),
    }
    times = {k: [] for k in fns}
    for r in range(3):
        for pair in (("eager replay", "graphed replay"),
                     ("eager step", "graphed step")):
            for k in (pair if r % 2 == 0 else pair[::-1]):
                times[k].append(host_s(fns[k])[0])
    med = {k: statistics.median(v) for k, v in times.items()}
    peaks = {}
    for k in ("eager step", "graphed step"):
        torch.cuda.reset_peak_memory_stats()
        host_s(fns[k])
        peaks[k] = torch.cuda.max_memory_allocated() / 1e9
    last = dg.GRAPHS.last
    log(f"  {what}, in turns, median of 3 (all 3): "
        + "; ".join(f"{k} {med[k] * 1e3:.1f} ms "
                    f"({', '.join(f'{t * 1e3:.1f}' for t in times[k])})"
                    for k in fns)
        + f"; replay {med['eager replay'] / med['graphed replay']:.2f}x, "
        f"step {med['eager step'] / med['graphed step']:.2f}x; the latest "
        f"capture: warm-up {last['warmup_s']:.3f} s, capture "
        f"{last['capture_s']:.3f} s, pool {last['pool_bytes'] / 1e9:.3f} "
        f"GB; peak memory allocated in a step: eager "
        f"{peaks['eager step']:.3f} GB, graphed {peaks['graphed step']:.3f}"
        f" GB (the pool beside it); graphs: {dg.GRAPHS.captures} captures "
        f"({dg.GRAPHS.warmups} warm-ups), {dg.GRAPHS.replays} replays so "
        f"far; on {card}")
    return dict(times=med, peaks=peaks, capture=last)


def reset_counts():
    mk.render_pixels_mega.launches = 0
    mk.render_pixels_mega.tape_launches = 0
    rm.record_paths_mega.launches = 0
    mc.render_pixels_mega_clustered.launches = 0
    rm.record_paths_mega_clustered.launches = 0
    ip.intersect_pallas.launches = 0
    ic.intersect_clustered.launches = 0
    traverse.intersect_bvh.launches = 0
    rng.uniforms.launches = 0
    rcam.camera_rays.launches = 0
    wp.shade.launches = 0
    wp.regenerate.launches = 0
    dh.dense_hit.launches = 0
    dh.dense_hit.masked_launches = 0
    rpass.record_step.launches = 0
    rpass.record_step.length_launches = 0
    rpass.record_shade.launches = 0
    rpass.record_shade.refill_launches = 0
    rreplay.replay.launches = 0
    rreplay.replay.backward_launches = 0
    gr.gather_rows.launches = 0
    gr.gather_rows.backward_launches = 0
    graphed.LOOPS.reset_counts()


def wavefront_tape(scene, cam, cfg, key, ray0, num_rays, chunk=1 << 13,
                   f64=False):
    """The wavefront ``record_paths`` over a ray range, in chunks; with
    ``f64`` on the scene and the camera rays in float64, through the
    plain route (``plain_lockstep``: K11 and K12 take float32), in chunks
    so that its dense (rays, primitives) temporaries stay bounded."""
    sc = to_f64(scene) if f64 else scene
    parts = []
    for lo in range(ray0, ray0 + num_rays, chunk):
        ids = torch.arange(lo, min(lo + chunk, ray0 + num_rays),
                           device=scene.device)
        o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                             rng.camera_uniforms(key, ids))
        if f64:
            parts.append(plain_lockstep(sc, o.double(), d.double(), ids, key,
                                        cfg)[:cfg.max_depth + 1])
        else:
            parts.append(record_paths(sc, o, d, ids, key, cfg))
    return torch.cat(parts, dim=1)


def wavefront_agreement(what, got, want, want32, scene):
    """A megakernel recorder's tape (``got``) on a far field against the
    plain wavefront ``record_paths`` run in float64 (``want``): per-entry
    agreement of 0.999 or above (tests/test_record_mega.py's floor).
    Beside it, logged, the agreement with the same recorder in float32
    (``want32``), whose float32 discriminant puts far hit points up to
    ~1e-3 off the surface, so that its bounce rays re-hit their own
    sphere; the log counts the rays whose first difference is such a
    re-hit (the same non-dielectric sphere twice in a row, which a convex
    surface cannot give) in each tape.  Returns the agreement."""
    refracts = torch.zeros(scene.num_primitives, dtype=torch.bool,
                           device=got.device)
    refracts[:scene.num_spheres] = scene.mat_type[scene.sphere_mat.long()] \
        == 2

    def rehits(a, b):
        diff = a != b
        differs = diff.any(dim=0)
        d = diff.int().argmax(dim=0)

        def count(tape):
            prev = tape.gather(0, (d - 1).clamp(min=0)[None])[0]
            cur = tape.gather(0, d[None])[0]
            return int((differs & (d >= 1) & (cur == prev) & (cur >= 0)
                        & ~refracts[cur.clamp(min=0).long()]).sum())

        return (float((~diff).float().mean()), int(differs.sum()), count(a),
                count(b))

    agree, rays, mine, theirs = rehits(got, want)
    agree32, rays32, mine32, theirs32 = rehits(got, want32)
    log(f"  {what}: tape agreement {agree:.6f} with the float64 wavefront "
        f"(floor 0.999), {rays} of {got.shape[1]} rays differ ({mine} first "
        f"by a re-hit of the same sphere in the kernel's tape, {theirs} in "
        f"the wavefront's); {agree32:.6f} with the float32 wavefront "
        f"(logged), {rays32} rays differ ({mine32} and {theirs32} by a "
        f"re-hit)")
    if not agree >= 0.999:
        raise AssertionError(f"{what}: agreement {agree} below 0.999")
    return agree


def bit_equal(what, got, want, against="the plain version"):
    """Fails unless each tensor of ``got`` equals its partner in ``want``
    bit for bit; logs the largest difference of each."""
    diffs = [float((a.double() - b.double()).abs().max()) if a.numel() else
             0.0 for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"    {what}: bit-equal to {against} {same} (largest "
        f"differences {diffs})")
    if not same:
        raise AssertionError(f"{what} differs from {against}")


def tape_agreement(what, got, want, floor):
    """Per-entry agreement of two tapes; logs it with the rays that
    differ and fails below ``floor``."""
    agree = float((got == want).float().mean())
    rays = int((got != want).any(dim=0).sum())
    log(f"  {what}: tape agreement {agree:.6f} (floor {floor}), {rays} of "
        f"{got.shape[1]} rays differ")
    if not agree > floor:
        raise AssertionError(f"{what}: tape agreement {agree} <= {floor}")
    return agree


def build():
    """Phase 2: the one library of K1-K17."""
    _, info = mk.load_mega_library()
    log(f"build: {os.path.relpath(info.path, ROOT)} (nvcc "
        f"{info.seconds:.2f} s, cached={info.cached})")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    for label, fn, regs, spills in ptxas_kernels(info.log):
        log(f"  {label} {fn[:60]}: {regs} registers, {spills}")


def ptxas_kernels(text):
    """(label, function, registers, spill line) of each entry in ptxas -v
    output, labelled K1-K17."""
    out, entry, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill" in line and entry:
            spills = line.strip()
        elif "registers" in line and entry:
            regs = int(line.split("Used", 1)[1].split("registers")[0])
            label = next(k for n, k in KERNEL_ENTRIES if n in entry)
            out.append((label, entry, regs, spills))
            entry = None
    return out


def render_path(dev, key, card):
    """Phases 3 and 4: K1 against its plain version, then the render path.
    Returns K1's entry of the kernels line and the final scene."""
    for preset, kw in SMALL_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mk.pack_scene_mega(scene)
        before = mk.render_pixels_mega.launches
        rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
        torch.cuda.synchronize()
        if mk.render_pixels_mega.launches != before + 1:
            raise AssertionError("launch counter did not move")
        ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
        compare(rad, segs, ref, ref_segs, cfg.spp,
                f"{preset} {cfg.nx}x{cfg.ny}@{cfg.spp}")
        bit_equal("K1", (rad, segs), (ref, ref_segs))

    scene, cam, cfg = build_preset("random-spheres", device=dev)
    pack = mk.pack_scene_mega(scene)
    t0 = time.perf_counter()
    ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    torch.cuda.synchronize()
    max_abs_err = compare(rad, segs, ref, ref_segs, cfg.spp,
                          f"final scene {cfg.nx}x{cfg.ny}@{cfg.spp}")
    bit_equal("K1 at full size", (rad, segs), (ref, ref_segs))
    log(f"  plain version at full size: {plain_ms:.1f} ms (one run)")
    del ref, ref_segs, rad, segs

    # 4. The render path at full size, through the user's entry point.
    golden = final_golden()
    reset_counts()
    img = mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    launches = mk.render_pixels_mega.launches
    if launches < 1:
        raise AssertionError("the render path did not launch K1")
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    checksum = float(img.double().sum()) * cfg.spp
    rel = abs(checksum - golden) / golden
    log(f"render path: radiance sum {checksum:.1f} vs golden {golden:.1f} "
        f"(rel {rel:.2e}), K1 launches {launches}")
    if not rel < 1e-2:
        raise AssertionError(f"radiance sum off golden by {rel:.3g}")
    os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
    write_png(os.path.join(ROOT, "out", "final_torch.png"), img)

    seconds = []
    for _ in range(4):  # one warm run, then three timed
        t0 = time.perf_counter()
        mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    sec = statistics.median(seconds[1:])
    READINGS["mega final scene"] = cfg.num_rays / sec / 1e6
    _, segs, steps = mk.render_pixels_mega(pack, cam, cfg, key,
                                           return_iters=True)
    rays = int(segs.sum())
    # A warp's lanes trace segments in step: segments over 32 x steps is
    # its lane efficiency.  Without regeneration a warp of 32 pixels ran
    # until its busiest pixel was done (mk.pixel_lane_steps).
    lane_eff = rays / (32 * int(steps.long().sum()))
    lane_eff_pixel = rays / (32 * int(mk.pixel_lane_steps(segs).long().sum()))
    kernel_ms = cuda_ms(lambda: mk.render_pixels_mega(pack, cam, cfg, key),
                        3)
    bound_ms, bound_by = bound(pack, rays, 16 * cfg.num_pixels)
    log(f"final scene {cfg.nx}x{cfg.ny}@{cfg.spp}spp depth "
        f"{cfg.max_depth}: {sec:.4f} s/frame median of 3, "
        f"{cfg.num_rays / sec / 1e6:.3f} Mpaths/s, "
        f"{rays / sec / 1e6:.3f} Mrays/s ({rays} segments); K1 alone "
        f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}), warp "
        f"lane efficiency {lane_eff:.3f} (one pixel a lane: "
        f"{lane_eff_pixel:.3f}); plain {plain_ms:.1f} ms; on {card}")
    k1 = {"name": "K1 megakernel (render_pixels_mega)", "route": "cuda",
          "source": "first_raytracer_tpu_torch/kernels/csrc/megakernel.cu",
          "replaces": mk.REPLACES, "launches": launches,
          "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return k1, scene, cam, cfg, pack, img.cpu(), (lane_eff, rays), segs


def tape_kernels_vs_plain(dev, key, card, scene, cam, cfg, pack, k1_segs):
    """Phase 5.  ``k1_segs``: K1's segments over the frame (phase 3 holds
    K1 bit-equal to its plain version)."""
    for preset, kw in SMALL_CASES:
        s, c, cf = build_preset(preset, device=dev, **kw)
        p = mk.pack_scene_mega(s)
        rad, segs = mk.render_pixels_mega(p, c, cf, key)
        before = (mk.render_pixels_mega.tape_launches,
                  rm.record_paths_mega.launches)
        rad2, segs2, tape = mk.render_pixels_mega(p, c, cf, key,
                                                  emit_tape=True)
        tape_b, its = rm.record_paths_mega(p, c, cf, key, return_iters=True)
        torch.cuda.synchronize()
        if (mk.render_pixels_mega.tape_launches,
                rm.record_paths_mega.launches) != (before[0] + 1,
                                                   before[1] + 1):
            raise AssertionError("K2 or K2b launch counter did not move")
        if not (torch.equal(rad2, rad) and torch.equal(segs2, segs)):
            raise AssertionError(f"{preset}: K2 changed K1's results")
        if not torch.equal(tape_b, tape):
            raise AssertionError(f"{preset}: K2b's tape differs from K2's")
        if not torch.equal(its.reshape(-1, cf.spp).sum(1, dtype=torch.int32),
                           segs):
            raise AssertionError(f"{preset}: K2b's trips differ from K1's "
                                 "segments")
        ref_rad, ref_segs, ref = mk.render_pixels_mega_reference(
            p, c, cf, key, emit_tape=True)
        ref_b, ref_its = rm.record_paths_mega_reference(p, c, cf, key)
        bit_equal(f"{preset} K2", (rad2, segs2, tape), (ref_rad, ref_segs,
                                                        ref))
        bit_equal(f"{preset} K2b", (tape_b, its), (ref_b, ref_its))
        a2 = float((tape == ref).float().mean())
        ab = float((tape_b == ref_b).float().mean())
        floor = 0.99 if preset == "triangle-mesh" else 0.999
        e2 = float(((rad2 - ref_rad) / cf.spp).abs().max())
        eb = float((its - ref_its).abs().max())
        log(f"  {preset} {cf.nx}x{cf.ny}@{cf.spp}: K2 = K1 bit for bit; "
            f"tape agreement K2 {a2:.6f}, K2b {ab:.6f} (floor {floor}); "
            f"K2 radiance max err {e2:.3e}, K2b trip max err {eb:g}")
        if not (a2 > floor and ab > floor):
            raise AssertionError(f"{preset}: tape agreement below {floor}")

    # K2's path: the megakernel with its tape over the full frame.
    reset_counts()
    _, _, full = mk.render_pixels_mega(pack, cam, cfg, key, emit_tape=True)
    torch.cuda.synchronize()
    k2_launches = mk.render_pixels_mega.tape_launches
    if k2_launches < 1:
        raise AssertionError("render_pixels_mega(emit_tape=True) did not "
                             "launch K2")
    want = full[:, SLICE_RAY0:SLICE_RAY0 + SLICE_RAYS]
    p0 = SLICE_RAY0 // cfg.spp
    _, _, by_k2 = mk.render_pixels_mega(
        pack, cam, cfg, key, pix0=p0, num_pixels=-(-SLICE_RAYS // cfg.spp),
        emit_tape=True)
    off = SLICE_RAY0 - p0 * cfg.spp
    by_k2b = rm.record_paths_mega(pack, cam, cfg, key, ray0=SLICE_RAY0,
                                  num_rays=SLICE_RAYS)
    for what, got in (("K2", by_k2[:, off:off + SLICE_RAYS]),
                      ("K2b", by_k2b)):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: slice at ray {SLICE_RAY0} "
                                 "differs from the full-frame tape")
    ref, _ = rm.record_paths_mega_reference(pack, cam, cfg, key,
                                            ray0=SLICE_RAY0,
                                            num_rays=SLICE_RAYS)
    rays = int((ref != want).any(dim=0).sum())
    log(f"  slice against the plain K2b: agreement "
        f"{float((ref == want).float().mean()):.6f}, {rays} rays differ "
        "(bound: none)")
    if rays:
        raise AssertionError("the slice differs from the plain K2b's")
    log(f"  slice [{SLICE_RAY0}, +{SLICE_RAYS}) through K2 and K2b equals "
        "the full-frame K2 tape's columns")
    del want
    # K2b over the whole frame, where its warps regenerate across many
    # windows of ray ids.
    tape_f, its_f, steps_f = rm._launch_record(
        pack, mk.camera_table(cam).to(dev), cfg, key, 0, cfg.num_rays,
        cfg.spp, return_steps=True)
    torch.cuda.synchronize()
    bit_equal("K2b over the whole frame, its tape", (tape_f,), (full,),
              against="the full-frame K2 tape")
    bit_equal("K2b over the whole frame, its trips per pixel",
              (its_f.reshape(-1, cfg.spp).sum(1, dtype=torch.int32),),
              (k1_segs,), against="K1's segments")
    lo = cfg.num_rays - GRAD_RAYS
    ref_f, ref_its_f = rm.record_paths_mega_reference(
        pack, cam, cfg, key, ray0=lo, num_rays=GRAD_RAYS)
    bit_equal(f"K2b over the whole frame, its columns [{lo}, "
              f"{cfg.num_rays})", (tape_f[:, lo:], its_f[lo:]),
              (ref_f, ref_its_f))
    trips = int(its_f.long().sum())
    log(f"  K2b over the whole frame ({cfg.num_rays} ray ids): warp lane "
        f"efficiency {trips / (32 * int(steps_f.long().sum())):.4f} "
        f"({trips} trips, {int((steps_f > 0).sum())} warps took ids); on "
        f"{card}")
    del full, tape_f, its_f, steps_f, ref_f, ref_its_f
    torch.cuda.empty_cache()
    calls = {
        "K1": lambda: mk.render_pixels_mega(pack, cam, cfg, key),
        "K2": lambda: mk.render_pixels_mega(pack, cam, cfg, key,
                                            emit_tape=True),
        "K2b": lambda: rm.record_paths_mega(pack, cam, cfg, key)}
    runs = {k: [] for k in calls}
    for k in ("K1", "K2", "K2b", "K2b", "K2", "K1"):  # in turns
        runs[k].append(cuda_ms(calls[k], 3))
        torch.cuda.empty_cache()
    k1_ms, k2_ms, kb_ms = (statistics.mean(runs[k]) for k in calls)
    log(f"full frame, in turns K1 K2 K2b K2b K2 K1 (median of 3 each): K1 "
        f"{runs['K1']} ms, K2 {runs['K2']} ms, K2b {runs['K2b']} ms; tape "
        f"write +{k2_ms - k1_ms:.3f} ms ({(k2_ms / k1_ms - 1) * 100:.1f}%); "
        f"K2b/K2 {kb_ms / k2_ms:.3f}; on {card}")
    return k2_launches


def grad_path(dev, key, card, scene, cam, cfg, pack):
    """Phase 6.  Returns the launches and times for the kernels line."""
    R = GRAD_RAYS
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)

    def record():
        return rm.record_paths_mega(pack, cam, cfg, key, num_rays=R)

    def record_k2():
        return mk.render_pixels_mega(pack, cam, cfg, key,
                                     num_pixels=-(-R // cfg.spp),
                                     emit_tape=True)[2][:, :R]

    def step():
        tape = record()
        plan = plan_buckets(tape)
        loss, grads = dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=plan)
        return tape, plan, loss, grads

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    tape, plan, loss, grads = step()
    tape_b, its = rm.record_paths_mega(pack, cam, cfg, key, num_rays=R,
                                       return_iters=True)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"K2b": rm.record_paths_mega.launches}
    log(f"grad path: launches {launches}, buckets {plan[1]}, peak memory "
        f"{peak_gb:.3f} GB (the first step: the graph's warm-up and "
        f"capture)")
    if launches["K2b"] < 2:
        raise AssertionError("the grad path did not record with K2b")
    segments = int(its.sum())

    # (a) K2 and K2b against their plain versions at this size, and K2's
    # tape against the plain wavefront recorder.
    pixels_k2 = -(-R // cfg.spp)  # K2 covers the pixels that hold the rays
    plain2_s, (ref_rad, ref_segs, ref_tape) = host_s(
        lambda: mk.render_pixels_mega_reference(
            pack, cam, cfg, key, num_pixels=pixels_k2, emit_tape=True))
    plain_b_s, (ref_b, ref_its) = host_s(
        lambda: rm.record_paths_mega_reference(pack, cam, cfg, key,
                                               num_rays=R))
    rad2, segs2, tape2 = mk.render_pixels_mega(pack, cam, cfg, key,
                                               num_pixels=pixels_k2,
                                               emit_tape=True)
    err2 = compare(rad2, segs2, ref_rad, ref_segs, cfg.spp,
                   f"K2 vs plain over {pixels_k2} pixels")
    bit_equal("K2 at 2^17 rays", (rad2, segs2, tape2),
              (ref_rad, ref_segs, ref_tape))
    bit_equal("K2b at 2^17 rays", (tape_b, its), (ref_b, ref_its))
    if not (torch.equal(tape2[:, :R], tape) and torch.equal(tape_b, tape)):
        raise AssertionError("K2b's tape, or K2's of the whole pixels, "
                             "differs from the step's")
    whole = R // cfg.spp
    if not torch.equal(its[:whole * cfg.spp].reshape(whole, cfg.spp).sum(
            1, dtype=torch.int32), segs2[:whole]):
        raise AssertionError("K2b's trips differ from K2's segments")
    agree2 = float((tape == ref_tape[:, :R]).float().mean())
    agree_b = float((tape_b == ref_b).float().mean())
    err_b = float((its - ref_its).abs().max())
    trips_rel = abs(segments - int(ref_its.sum())) / int(ref_its.sum())
    log(f"  (a) K2b = K2 (tapes; trips per pixel = segments); tape agreement "
        f"with the plain versions: K2 {agree2:.6f}, K2b {agree_b:.6f} (floor "
        f"0.999), {int((tape != ref_tape[:, :R]).any(dim=0).sum())} and "
        f"{int((tape_b != ref_b).any(dim=0).sum())} rays differ; K2b trips "
        f"{segments} vs {int(ref_its.sum())} (rel {trips_rel:.2e}), per ray "
        f"max err {err_b:g}")
    if not (agree2 > 0.999 and agree_b > 0.999):
        raise AssertionError("K2 or K2b tape off its plain version")
    if not trips_rel <= 1e-3:
        raise AssertionError(f"K2b trip totals differ ({trips_rel})")
    del ref_rad, ref_tape, ref_b, tape2
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    wave_s, wave = host_s(lambda: record_paths(scene, o, d, ids, key, cfg))
    agree = float((tape == wave).float().mean())
    differing = int((tape != wave).any(dim=0).sum())
    log(f"  (a) the step's tape (K2b) vs plain record_paths: agreement "
        f"{agree:.6f}, {differing} rays differ (record_paths "
        f"{wave_s * 1e3:.1f} ms, one run)")
    if not agree > 0.999:
        raise AssertionError(f"K2b tape agreement {agree}")
    del wave

    # (b) The replay's radiance per whole pixel against K1.
    with torch.no_grad():
        rad = trace_rays_replay(scene, o, d, ids, key, cfg, tape)
    rad_px = rad[:whole * cfg.spp].reshape(whole, cfg.spp, 3).sum(1)
    k1_rad, _ = mk.render_pixels_mega(pack, cam, cfg, key, num_pixels=whole)
    diff = ((rad_px - k1_rad) / cfg.spp).abs()
    frac = float((diff > 1e-3).float().mean())
    log(f"  (b) replay vs K1 over {whole} pixels: frac(|a-b|>1e-3)="
        f"{frac:.6f} max={float(diff.max()):.3e}")
    if not frac < 0.01:
        raise AssertionError(f"replay radiance off K1 ({frac})")

    # (c) Finite loss and gradients; the albedo gradient moves.
    if not bool(torch.isfinite(loss)):
        raise AssertionError("non-finite loss")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient {k}")
    if not float(grads["albedo"].abs().max()) > 0.0:
        raise AssertionError("zero albedo gradient")

    # (d) The JAX package's golden, computed on the CPU, and its tape.
    with open(GRAD_GOLDEN) as f:
        golden = json.load(f)
    with np.load(GRAD_GOLDEN_TAPE) as saved:
        jax_tape = torch.from_numpy(saved["tape"].astype(np.int32)).to(dev)
    agree_j = float((tape == jax_tape).float().mean())
    rays_j = int((tape != jax_tape).any(dim=0).sum())
    log(f"  (d) the step's tape (K2b) vs JAX's tape: agreement "
        f"{agree_j:.6f}, {rays_j} rays differ")
    if not agree_j > 0.999:
        raise AssertionError(f"K2b tape agreement with JAX's {agree_j}")
    f64 = golden["f64"]
    want64 = {k: v["values"] for k, v in f64["fields"].items()}
    # (d1) float32, on K2b's tape (the step as run) and on JAX's: the loss
    # within 1% and the albedo gradient within 5% of JAX's float32 values.
    # The fields of TANGENT_FIELDS are only logged here: in float32 they
    # move by tens of percent between tapes or roundings in either package.
    loss_j, grads_j = dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids, target, jax_tape)
    for what, l32, g32 in (("K2b's", loss, grads),
                           ("JAX's", loss_j, grads_j)):
        rel = abs(float(l32) - golden["loss"]) / golden["loss"]
        log(f"  (d1) float32 on {what} tape: loss {float(l32):.9g}, rel "
            f"{rel:.3e} (bound 1e-2)")
        if not rel < 1e-2:
            raise AssertionError(f"loss on {what} tape off by {rel:.3g}")
        check_grads(f"(d1) {what} tape", {"albedo": g32["albedo"]},
                    {"albedo": golden["fields"]["albedo"]["values"]},
                    lambda k: 0.05)
        for k in TANGENT_FIELDS:
            err = rel_err(g32[k], torch.tensor(want64[k],
                                               dtype=torch.float64))[0]
            log(f"      {k}: {err:.4f} from JAX's float64 (JAX's own "
                f"float32: {f64['fields'][k]['f32']['rel_err']})")
    # (d1') The float32 loss on JAX's tape against JAX's forward replay of
    # that tape (trace_rays_replay), the JAX program that computes the same
    # float32 values, within the spread between JAX's two float32 programs
    # (forward replay against the gradient program, both in the golden).
    # The gradient program's loss sits 1.7e-5 from float64 and the forward
    # replay's 3.5e-4: XLA contracts a few chaotic rays' arithmetic
    # differently in each program, so the golden's loss is no bound for a
    # forward replay.  K2b's tape parts from JAX's on a few rays, so its
    # loss is logged beside, not held.
    fwd = golden["forward_replay"]
    for what, l32 in (("JAX's", loss_j), ("K2b's", loss)):
        rel = abs(float(l32) - fwd["loss"]) / fwd["loss"]
        log(f"  (d1') float32 on {what} tape against JAX's forward replay "
            f"{fwd['loss']:.9g}: rel {rel:.3e} (bound, on JAX's tape: "
            f"{fwd['spread']:.3e})")
    rel_fwd = abs(float(loss_j) - fwd["loss"]) / fwd["loss"]
    if not rel_fwd <= fwd["spread"]:
        raise AssertionError(f"float32 loss on JAX's tape off JAX's forward "
                             f"replay by {rel_fwd:.3g}")
    # (d2) float64 on JAX's tape: every field against JAX's float64 replay.
    scene64, cam64 = to_f64(scene), to_f64(cam)
    params64, _ = dg.split_params(scene64)
    loss64, grads64 = dg.render_loss_and_grads_bucketed(
        params64, scene64, cam64, cfg, key, ids, target.double(), jax_tape)
    rel64 = abs(float(loss64) - f64["loss"]) / f64["loss"]
    log(f"  (d2) float64 on JAX's tape: loss {float(loss64):.17g}, rel "
        f"{rel64:.3e} (bound {F64_BOUND:g})")
    if not (loss64.dtype == torch.float64 and rel64 < F64_BOUND):
        raise AssertionError(f"float64 loss off JAX's by {rel64:.3g}")
    check_grads("(d2) float64", grads64, want64,
                lambda k: F64_TANGENT_BOUND if k in TANGENT_FIELDS
                else F64_BOUND)
    del scene64, cam64, params64, grads64

    # (e) The graphed value and gradient against its eager body, for two
    # keys and after a parameter update, and both timed in turns.
    turns = graph_against_eager(
        "final scene, K2b", scene, cam, cfg, ids, target,
        dg.tape_recorder(scene, cam, cfg, ids, dev),
        (key, rng.base_key(1)), card)

    # Times, median of 3 after the warm step above.
    k2_ms = cuda_ms(record_k2, 3)
    kb_ms = cuda_ms(record, 3)
    replay_s = turns["times"]["graphed replay"]
    step_s = turns["times"]["graphed step"]
    READINGS["grad final scene"] = R / step_s / 1e6
    D = cfg.max_depth + 1
    k2_bound = bound(pack, int(segs2.sum()),
                     16 * pixels_k2 + 4 * D * pixels_k2 * cfg.spp)
    kb_bound = bound(pack, segments, 4 * (D + 1) * R)
    _, _, kb_steps = rm._launch_record(pack, mk.camera_table(cam).to(dev),
                                       cfg, key, 0, R, cfg.spp,
                                       return_steps=True)
    kb_lanes = segments / (32 * int(kb_steps.long().sum()))
    log(f"  at {R} rays: K2 {k2_ms:.3f} ms (bound {k2_bound[0]:.4f} ms), "
        f"K2b {kb_ms:.3f} ms (bound {kb_bound[0]:.4f} ms, warp lane "
        f"efficiency {kb_lanes:.4f}), plain K2 "
        f"{plain2_s * 1e3:.1f} ms, plain K2b {plain_b_s * 1e3:.1f} ms (one "
        f"run each); on {card}")
    log(f"  graphed replay value and gradient {replay_s * 1e3:.1f} ms; "
        f"whole step (record + plan + graphed value and gradient) "
        f"{step_s * 1e3:.1f} ms: "
        f"{R / step_s / 1e6:.4f} gradient Mpaths/s, "
        f"{segments / step_s / 1e6:.3f} Mrays/s ({segments} segments), "
        f"replay {replay_s / step_s * 100:.1f}% of the step (K2b records); "
        "peak memory "
        f"{peak_gb:.3f} GB; on {card}")
    return dict(launches=launches, k2_ms=k2_ms, kb_ms=kb_ms,
                step=(tape.cpu(), float(loss),
                      {k: v.cpu() for k, v in grads.items()}),
                plain2_ms=plain2_s * 1e3, plain_b_ms=plain_b_s * 1e3,
                k2_bound=k2_bound, kb_bound=kb_bound, err2=err2,
                err_b=err_b, agree2=agree2, agree_b=agree_b)


def fit_cli(card):
    """Phase 7: the fit CLI in subprocesses on the card, the record->replay
    step (``--fast``) and the direct step."""
    base = ["--preset", "random-spheres", "--nx", "64", "--ny", "32",
            "--spp", "2", "--opt", "adam", "--lr", "0.05", "--steps", "5"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    for what, args in (("--fast", ["--fields", "albedo", "--fast"]),
                       ("direct", [])):
        cmd = [sys.executable, "-m", "first_raytracer_tpu_torch.cli", "fit",
               *base, *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"fit CLI ({what}) exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines()]
        steps, last = lines[:-1], lines[-1]
        log(f"fit CLI: {' '.join(cmd[3:])} in "
            f"{time.perf_counter() - t0:.1f} s: losses "
            f"{[s['loss'] for s in steps]}, {last}")
        if not steps[-1]["loss"] < steps[0]["loss"]:
            raise AssertionError(f"the fit's loss did not fall ({what})")
        if last["device"] != "cuda":
            raise AssertionError(f"the fit ({what}) did not run on the card")
        graphs, loops = last["graphs"], last["loops"]
        log(f"  the fit's value and gradient: {graphs['captures']} graph "
            f"captures against {graphs['replays']} replays over 5 steps; "
            f"the recorder's loops: {loops}")
        if graphs["replays"] != 5:
            raise AssertionError(f"the fit's steps ({what}) did not replay "
                                 "the graph")
        if what == "--fast" and last["kernel_launches"]["K2b"] < 5:
            raise AssertionError("the fit did not record with K2b on the "
                                 "card")
        # The direct step records the target, then each step, in the
        # loop's graphs: one capture, and at least a block replayed a call.
        if what == "direct" and not (loops["captures"] == 1
                                     and loops["replays"] >= 6):
            raise AssertionError("the direct fit's recorder did not replay "
                                 "its graphs every step")


def clustered_vs_plain(dev, key, card):
    """Phase 8.  Returns K1's and K3's times on field5000 and the final
    scene."""
    for preset, kw in CLUSTER_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        before = mc.render_pixels_mega_clustered.launches
        rad, segs, sweeps = mc.render_pixels_mega_clustered(
            pack, cam, cfg, key, return_iters=True)
        torch.cuda.synchronize()
        if mc.render_pixels_mega_clustered.launches != before + 1:
            raise AssertionError("K3's launch counter did not move")
        ref, ref_segs, ungated = mc.render_pixels_mega_clustered_reference(
            pack, cam, cfg, key, return_iters=True)
        what = (f"{preset} {kw.get('n', '')} {cfg.nx}x{cfg.ny}@{cfg.spp} "
                f"({pack.clusters} + {pack.tri_clusters} clusters)")
        compare_clustered(rad, segs, ref, ref_segs, cfg.spp, what,
                          per_pixel="triangle" in preset)
        bit_equal("K3", (rad, segs), (ref, ref_segs))
        done, full = sweeps.long().sum(0), ungated.long().sum(0)
        log(f"    sweeps: {done.tolist()} of an ungated sweep's "
            f"{full.tolist()} ({', '.join(mc.SWEEP_COLUMNS)})")
        if not bool((sweeps[:, :3] <= ungated[:, :3]).all()):
            raise AssertionError(f"{what}: K3 swept more than every cluster")
        dpack = mk.pack_scene_mega(scene)
        if max(scene.num_spheres, scene.num_triangles) <= mk.DENSE_MAX:
            ms1 = cuda_ms(lambda: mk.render_pixels_mega(dpack, cam, cfg, key),
                          5)
            ms3 = cuda_ms(lambda: mc.render_pixels_mega_clustered(
                pack, cam, cfg, key), 5)
            log(f"    K1 {ms1:.4f} ms, K3 {ms3:.4f} ms (median of 5); on "
                f"{card}")

    # K3 against K1 at full size, on field5000 and on the final scene.
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        goldens = json.load(f)
    times = {}
    for label, preset, kw in (("field5000", "sphere-field", dict(n=5000)),
                              ("final scene", "random-spheres", {})):
        scene_, cam_, cfg_ = build_preset(preset, device=dev, **kw)
        dpack = mk.pack_scene_mega(scene_)
        cpack = mc.pack_scene_mega_clustered(scene_, cam_)
        rad1, segs1 = mk.render_pixels_mega(dpack, cam_, cfg_, key)
        rad3, segs3 = mc.render_pixels_mega_clustered(cpack, cam_, cfg_, key)
        diff = ((rad3 - rad1) / cfg_.spp).abs().cpu()
        frac = float((diff > 1e-3).float().mean())
        ms = {k: cuda_ms(fn, 3) for k, fn in (
            ("K1", lambda: mk.render_pixels_mega(dpack, cam_, cfg_, key)),
            ("K3", lambda: mc.render_pixels_mega_clustered(cpack, cam_, cfg_,
                                                           key)))}
        times[label] = ms
        log(f"  K3 vs K1, {label} {cfg_.nx}x{cfg_.ny}@{cfg_.spp}: "
            f"frac(|a-b|>1e-3)={frac:.6f} max={float(diff.max()):.3e}, "
            f"segments {int(segs3.sum())} vs {int(segs1.sum())}; K1 "
            f"{ms['K1']:.3f} ms, K3 {ms['K3']:.3f} ms; on {card}")
        if not frac < 0.01:
            raise AssertionError(f"K3 off K1 on {label} ({frac})")
        if preset == "random-spheres":
            total = float(rad3.double().sum())
            rel = abs(total - goldens[GOLDEN_KEY]) / goldens[GOLDEN_KEY]
            log(f"    final scene through K3: radiance sum {total:.1f} vs "
                f"golden {goldens[GOLDEN_KEY]:.1f} (rel {rel:.2e})")
            if not rel < 1e-2:
                raise AssertionError(f"K3's final scene off golden ({rel})")
        del rad1, rad3
    return times


def large_scene_path(dev, key, card):
    """Phase 9.  Returns K3's launches, per scene its times, bound and error
    against the plain version, and the field scenes for phase 10."""
    out, scenes = {}, {}
    launches = 0
    for label, preset, n, gkey in FIELD_SCENES:
        scene, cam, cfg = build_preset(preset, device=dev, n=n)
        scenes[label] = (scene, cam, cfg)
        reset_counts()
        img = mc.render_image_mega_clustered(scene, cam, cfg, seed=0,
                                             device=dev)
        torch.cuda.synchronize()
        frame_launches = mc.render_pixels_mega_clustered.launches
        launches += frame_launches
        if frame_launches != 1:
            raise AssertionError(f"{label}: {frame_launches} K3 launches "
                                 "for one frame")
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image")
        field_golden(f"{label} {cfg.nx}x{cfg.ny}@{cfg.spp} depth "
                     f"{cfg.max_depth}, K3 launches {frame_launches}", label,
                     gkey, float(img.double().sum()) * cfg.spp)
        os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
        write_png(os.path.join(ROOT, "out", f"{label}_torch.png"), img)
        seconds = []
        for _ in range(4):  # one warm run, then three timed
            seconds.append(host_s(lambda: mc.render_image_mega_clustered(
                scene, cam, cfg, seed=0, device=dev))[0])
        sec = statistics.median(seconds[1:])
        READINGS[f"megacluster {label}"] = cfg.num_rays / sec / 1e6
        pack_s = statistics.median(host_s(
            lambda: mc.pack_scene_mega_clustered(scene, cam))[0]
            for _ in range(3))
        pack = mc.pack_scene_mega_clustered(scene, cam)
        rad, segs, sweeps = mc.render_pixels_mega_clustered(
            pack, cam, cfg, key, return_iters=True)
        rays = int(segs.sum())
        k3_ms = cuda_ms(
            lambda: mc.render_pixels_mega_clustered(pack, cam, cfg, key), 3)
        tot = sweeps.long().sum(0).tolist()
        b = clustered_bound(pack, sweeps, 32 * cfg.num_pixels)
        log(f"  {sec:.4f} s/frame median of 3 ({cfg.num_rays / sec / 1e6:.3f}"
            f" Mpaths/s, {rays / sec / 1e6:.3f} Mrays/s, {rays} segments); "
            f"host pack {pack_s:.4f} s; K3 alone {k3_ms:.3f} ms "
            f"({cfg.num_rays / k3_ms / 1e3:.1f} Mpaths/s; bound {b[0]:.4f} "
            f"ms, {b[1]}); per segment {tot[0] / rays:.2f} clusters swept, "
            f"{tot[1] / rays:.1f} sphere and {tot[2] / rays:.1f} triangle "
            f"slots, {tot[3] / rays:.1f} boxes tested; on {card}")
        log(f"  per warp step: {tot[4] / tot[5]:.2f} clusters swept by the "
            f"warp (its union), {tot[0] / tot[5]:.2f} opened by its lanes; "
            f"lane efficiency {rays / (32 * tot[5]):.3f}")
        # K3's output at this shape against its plain version, on the
        # middle quarter of the frame's pixels (the plain version's time
        # over whole frames pushed the script past ten minutes).
        p0, n_px = 3 * cfg.num_pixels // 8, cfg.num_pixels // 4
        mc.check_clustered_guards(pack, cfg)
        plain_s, (ref, ref_segs) = host_s(lambda: mk.render_reference(
            pack, cam, cfg, key, pix0=p0, num_pixels=n_px,
            rays_per_chunk=PLAIN_PAIRS // pack.sweep_columns))
        band = slice(p0, p0 + n_px)
        err = compare_clustered(rad[band], segs[band], ref, ref_segs,
                                cfg.spp, f"  K3 vs plain, pixels [{p0}, "
                                f"{p0 + n_px}) of the frame",
                                per_pixel=preset == "triangle-field")
        differ = int(((rad[band] != ref).any(dim=1)
                      | (segs[band] != ref_segs)).sum())
        log(f"    pixels that differ at all: {differ} of {n_px}")
        if preset == "triangle-field":  # the design reaches bit-equality
            bit_equal("K3 on the quarter", (rad[band], segs[band]),
                      (ref, ref_segs))
        log(f"  plain version {plain_s * 1e3:.1f} ms on a quarter of the "
            "frame (one run)")
        out[label] = dict(ms=k3_ms, bound=b, sec=sec, err=err, img=img.cpu(),
                          plain_ms=plain_s * 1e3, differ=differ)
        del ref, ref_segs, rad
        torch.cuda.empty_cache()
    return launches, out, scenes


def clustered_tapes_and_step(dev, key, card, scenes):
    """Phase 10.  Returns K3t's entries for the kernels line."""
    for preset, kw in CLUSTER_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        before = rm.record_paths_mega_clustered.launches
        tape = rm.record_paths_mega_clustered(pack, cam, cfg, key)
        torch.cuda.synchronize()
        if rm.record_paths_mega_clustered.launches != before + 1:
            raise AssertionError("K3t's launch counter did not move")
        ref, _ = rm.record_paths_mega_clustered_reference(pack, cam, cfg,
                                                          key)
        tape_agreement(f"K3t vs plain, {preset} {kw.get('n', '')} "
                       f"{cfg.nx}x{cfg.ny}@{cfg.spp}", tape, ref,
                       0.99 if "triangle" in preset else 0.999)

    R = GRAD_RAYS
    scene, cam, cfg = scenes["field5000"]
    cpack = mc.pack_scene_mega_clustered(scene, cam)
    dpack = mk.pack_scene_mega(scene)
    tape3, its3, sweeps3 = rm.record_paths_mega_clustered(
        cpack, cam, cfg, key, num_rays=R, return_iters=True)
    tape_b = rm.record_paths_mega(dpack, cam, cfg, key, num_rays=R)
    agree_k2b = tape_agreement(f"field5000 rays [0, {R}): K3t vs K2b",
                               tape3, tape_b, 0.999)
    plain_s, (ref3, ref_its3) = host_s(
        lambda: rm.record_paths_mega_clustered_reference(
            cpack, cam, cfg, key, num_rays=R))
    trips_err = int((its3 - ref_its3).abs().max())
    agree_plain = tape_agreement("  K3t vs its plain version", tape3, ref3,
                                 0.999)
    del ref3
    wave5 = wavefront_tape(scene, cam, cfg, key, 0, R, f64=True)
    wave5_32 = wavefront_tape(scene, cam, cfg, key, 0, R)
    wavefront_agreement("  K3t vs the plain wavefront record_paths", tape3,
                        wave5, wave5_32, scene)
    wavefront_agreement("  K2b vs the plain wavefront record_paths", tape_b,
                        wave5, wave5_32, scene)
    del wave5, wave5_32
    k3t_ms = cuda_ms(lambda: rm.record_paths_mega_clustered(
        cpack, cam, cfg, key, num_rays=R), 3)
    bound = clustered_bound(cpack, sweeps3, 4 * (cfg.max_depth + 6) * R)

    s20, c20, cfg20 = scenes["field20000"]
    p20 = mc.pack_scene_mega_clustered(s20, c20)
    t20, its20, sweeps20 = rm.record_paths_mega_clustered(
        p20, c20, cfg20, key, num_rays=R, return_iters=True)
    lanes = {f: int(i.long().sum()) / (32 * int(w[:, 5].long().sum()))
             for f, i, w in (("field5000", its3, sweeps3),
                             ("field20000", its20, sweeps20))}
    ref20, _ = rm.record_paths_mega_clustered_reference(p20, c20, cfg20,
                                                        key, num_rays=R)
    tape_agreement(f"field20000 rays [0, {R}): K3t vs its plain version",
                   t20, ref20, 0.999)
    del ref20
    wavefront_agreement("  K3t vs the plain wavefront record_paths", t20,
                        wavefront_tape(s20, c20, cfg20, key, 0, R, f64=True),
                        wavefront_tape(s20, c20, cfg20, key, 0, R), s20)
    k3t20_ms = cuda_ms(lambda: rm.record_paths_mega_clustered(
        p20, c20, cfg20, key, num_rays=R), 3)
    del t20, its20, sweeps20, p20

    # One clustered fit step on field5000 through the user's entry point.
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = dg.make_optimizer("adam", params, 1e-3)
    step = dg.make_fit_step_replay(scene, cam, cfg, ids, target, opt,
                                   device=dev)
    reset_counts()
    loss = step(params, key)
    torch.cuda.synchronize()
    launches = rm.record_paths_mega_clustered.launches
    log(f"clustered fit step, field5000, {R} rays: loss {float(loss):.9g}, "
        f"launches K3t {launches}, K2b {rm.record_paths_mega.launches}")
    if launches != 1 or rm.record_paths_mega.launches:
        raise AssertionError("the clustered fit step did not record with "
                             "K3t alone")
    grads = {k: v.grad for k, v in params.items()}
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("non-finite loss or gradient")
    base = dataclasses.replace(scene, **start)
    p0 = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    loss_b, _ = dg.render_loss_and_grads_bucketed(p0, base, cam, cfg, key,
                                                  ids, target, tape_b)
    rel = abs(float(loss) - float(loss_b)) / float(loss_b)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    with torch.no_grad():
        rad3 = trace_rays_replay(base, o, d, ids, key, cfg, tape3)
        rad_b = trace_rays_replay(base, o, d, ids, key, cfg, tape_b)
    same = (tape3 == tape_b).all(dim=0)
    bit_equal = torch.equal(rad3[same], rad_b[same])
    log(f"  loss on K2b's tape {float(loss_b):.9g} (rel {rel:.3e}, bound "
        f"1e-3); replayed radiance bit-equal on the {int(same.sum())} rays "
        f"whose tapes are equal: {bit_equal}")
    if not (rel < 1e-3 and bit_equal):
        raise AssertionError("the clustered step is off the step on K2b's "
                             "tape")
    if bool(same.all()) and float(loss) != float(loss_b):
        raise AssertionError("equal tapes, unequal losses")
    step_s = statistics.median(host_s(lambda: step(params, key))[0]
                               for _ in range(3))
    READINGS["grad field5000"] = R / step_s / 1e6
    graph_against_eager("field5000, K3t", scene, cam, cfg, ids, target,
                        dg.tape_recorder(scene, cam, cfg, ids, dev),
                        (key, rng.base_key(1)), card)
    segments = int(its3.sum())
    log(f"  K3t at {R} rays: field5000 {k3t_ms:.3f} ms (bound "
        f"{bound[0]:.4f} ms, {bound[1]}; plain {plain_s * 1e3:.1f} ms, one "
        f"run), field20000 {k3t20_ms:.3f} ms; warp lane efficiency "
        f"{lanes}; the step {step_s * 1e3:.1f} ms"
        f" median of 3: {R / step_s / 1e6:.4f} gradient Mpaths/s, "
        f"{segments / step_s / 1e6:.3f} Mrays/s ({segments} segments); "
        f"trip counts off the plain version's by at most {trips_err}; on "
        f"{card}")
    return dict(launches=launches, ms=k3t_ms, ms20=k3t20_ms,
                trips_err=trips_err,
                plain_ms=plain_s * 1e3, bound=bound, agree=agree_plain,
                agree_k2b=agree_k2b)


class Clocked:
    """An ``intersect_fn`` that records CUDA events around each call of the
    wrapper ``fn`` (its kernel and the hit comparison after it) and, for
    K5, sums its per-ray counters on the card: the kernel's time and work
    over a whole frame without a host sync per call.  With ``keep`` it also
    keeps each batch, so that ``replay_ms`` can time the frame's calls back
    to back in a CUDA graph, without the host's time between them."""

    def __init__(self, fn, counters=False, keep=False):
        self.fn, self.counters, self.keep = fn, counters, keep
        self.events, self.rays, self.batches = [], 0, []
        self.sweeps = None

    def __call__(self, scene, accel, o, d, t_min):
        if self.keep:
            self.batches.append((o.clone(), d.clone(), t_min))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if self.counters:
            prim, t, hit, sweeps = self.fn(scene, accel, o, d, t_min,
                                           return_iters=True)
            s = sweeps.long().sum(0)
            self.sweeps = s if self.sweeps is None else self.sweeps + s
        else:
            prim, t, hit = self.fn(scene, accel, o, d, t_min)
        end.record()
        self.events.append((start, end))
        self.rays += o.shape[0]
        return prim, t, hit

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def replay_ms(self, scene, accel):
        """The kept batches through ``fn`` back to back, median of 3."""
        ms = graph_ms(lambda: [self.fn(scene, accel, o, d, t)
                               for o, d, t in self.batches], 3)
        self.batches = []
        return ms


def frame_stats(scene, cam, cfg, key, accel, intersect_fn=None, **kw):
    """The wavefront frame in chunks of ``WAVE_RAYS``, as ``render_image``
    traces it (the last chunk padded with the last id), with the segments:
    (per-pixel mean radiance (P, 3), per-pixel segments (P,)), pixels
    bottom row first.  ``kw`` goes to ``render_ray_batch`` (``graphed``)."""
    rad, segs = [], []
    total = cfg.num_rays
    for lo in range(0, total, WAVE_RAYS):
        ids = torch.arange(lo, lo + WAVE_RAYS, device=scene.device).clamp(
            max=total - 1)
        r, sg = render_ray_batch(scene, cam, cfg, key, ids, accel,
                                 intersect_fn, return_stats=True, **kw)
        rad.append(r)
        segs.append(sg)
    rad = torch.cat(rad)[:total].reshape(-1, cfg.spp, 3).mean(dim=1)
    segs = torch.cat(segs)[:total].reshape(-1, cfg.spp).sum(dim=1)
    return rad, segs


def capture_note(c):
    """The capture of a graphed frame's counters, for the log."""
    if not c["captures"]:
        return "no capture (its graphs were cached)"
    cap = c["capture"]
    return (f"{c['captures']} capture(s), {c['warmups']} warm-up(s): the "
            f"latest warm-up {cap['warmup_s']:.3f} s, capture "
            f"{cap['capture_s']:.3f} s, pool {cap['pool_bytes'] / 1e9:.3f} "
            "GB")


def loop_counts():
    """The wavefront graphs' counters since ``reset_counts``, and the
    latest capture."""
    loops = graphed.LOOPS
    return dict(captures=loops.captures, warmups=loops.warmups,
                replays=loops.replays, passes=loops.passes,
                live_passes=loops.live_passes, syncs=loops.syncs,
                capture=loops.last)


def check_reads(what, counts, loops_run):
    """The host's reads of a graphed frame: one per block of
    ``PASSES_PER_READ`` passes, and fewer than a block of inert passes at
    the end of each of its ``loops_run`` loops (chunks, or the one pool):
    at most ceil(passes / K) + loops_run reads."""
    k = graphed.PASSES_PER_READ
    if counts["syncs"] * k != counts["passes"] or not (
            0 <= counts["passes"] - counts["live_passes"] < k * loops_run):
        raise AssertionError(f"{what}: {counts} off one read per {k} passes")


def graph_vs_eager(what, got, want):
    """Graphed against eager outputs: ``torch.equal`` each."""
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: the graphed frame differs from the "
                             "eager one")
    log(f"  {what}: graphed = eager (radiance and segments, torch.equal)")


def in_turns(frame, repeats):
    """Seconds of ``frame(graphed)`` eager, graphed, graphed, eager (the
    median of ``repeats`` frames a turn), each frame held ``torch.equal``
    to the first graphed one; returns {"eager": [s, s], "graphed": [s,
    s]}."""
    out = {"eager": [], "graphed": []}
    want = frame(True)
    for run in ("eager", "graphed", "graphed", "eager"):
        secs = []
        for _ in range(repeats):
            sec, img = host_s(lambda: frame(run == "graphed"))
            if not torch.equal(img, want):
                raise AssertionError(f"the {run} frame differs")
            secs.append(sec)
        out[run].append(statistics.median(secs))
    return out


def camera_rays(scene, cam, cfg, key, num_rays):
    ids = torch.arange(num_rays, device=scene.device)
    return rcam.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)


def same_hits(what, got, want):
    """Hit masks and primitives equal, t within 1e-6 relative; returns the
    largest |t| difference on the hits."""
    p1, t1, h1 = got
    p2, t2, h2 = want
    if not (torch.equal(h1, h2) and torch.equal(p1, p2)):
        raise AssertionError(f"{what}: hits or primitives differ "
                             f"({int((p1 != p2).sum())} rays)")
    err = float((t1[h1] - t2[h1]).abs().max()) if bool(h1.any()) else 0.0
    rel = float(((t1[h1] - t2[h1]).abs() / t2[h1]).max()) if bool(
        h1.any()) else 0.0
    if not rel <= 1e-6:
        raise AssertionError(f"{what}: t off by {rel:.3g} relative")
    return err


# Phase 11: the small scenes and a field past K4's tiles and K5's first
# gate tile at max_leaf 1 and 7.
INTERSECT_CASES = CLUSTER_CASES + [
    ("sphere-field", dict(n=5000, nx=64, ny=32, spp=2))]


def intersect_vs_plain(dev, key):
    """Phase 11.  Returns the largest t error of K4 and of K5 against their
    plain versions."""
    err4 = err5 = 0.0
    for preset, kw in INTERSECT_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        g = torch.Generator().manual_seed(0)
        o = (torch.rand((4096, 3), generator=g) * 16 - 8).to(dev)
        d = torch.randn((4096, 3), generator=g)
        d = (d / d.norm(dim=1, keepdim=True)).to(dev)
        dense = ip.pack_scene_pallas(scene)
        line = []
        for label, rays in (("random", (o, d)),
                            ("camera", camera_rays(scene, cam, cfg, key,
                                                   cfg.num_rays))):
            before = ip.intersect_pallas.launches
            k4 = ip.intersect_pallas(scene, dense, *rays, 1e-3)
            torch.cuda.synchronize()
            if ip.intersect_pallas.launches != before + 1:
                raise AssertionError("K4's launch counter did not move")
            err4 = max(err4, same_hits(
                f"K4 {preset} {label}", k4,
                ip.intersect_pallas_reference(scene, dense, *rays, 1e-3)))
            for max_leaf in (1, 7, 128):
                pack = ic.pack_scene_clustered(scene, max_leaf=max_leaf)
                before = ic.intersect_clustered.launches
                k5 = ic.intersect_clustered(scene, pack, *rays, 1e-3)
                torch.cuda.synchronize()
                if ic.intersect_clustered.launches != before + 1:
                    raise AssertionError("K5's launch counter did not move")
                what = f"K5 {preset} {label} max_leaf {max_leaf}"
                err5 = max(err5, same_hits(
                    what, k5, ic.intersect_clustered_reference(
                        scene, pack, *rays, 1e-3)))
                same_hits(f"{what} vs K4", k5, k4)
            line.append(f"{label} {int(k4[2].sum())}/{rays[0].shape[0]} "
                        "hits")
        log(f"  {preset} {kw.get('n', '')}: K4 = plain, K5 (max_leaf 1, 7, "
            f"128) = plain = K4 ({', '.join(line)})")
    return err4, err5


def dense_wavefront_path(dev, key, card):
    """Phase 12.  Returns K4's entry of the kernels line."""
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    golden = final_golden()
    pack = ip.pack_scene_pallas(scene)
    total = cfg.num_rays
    chunks = -(-total // WAVE_RAYS)

    def frame(mode, graphed_=None):
        return render_image(scene, cam, cfg, seed=0, accel=pack, mode=mode,
                            chunk=WAVE_RAYS, pool_size=WAVE_RAYS,
                            device=dev, graphed=graphed_)

    # The graphed frames (the first of each captures its loop).
    imgs, launches, loops, draws = {}, {}, {}, {}
    for mode in ("regenerative", "wavefront"):
        reset_counts()
        imgs[mode] = frame(mode)
        torch.cuda.synchronize()
        launches[mode] = ip.intersect_pallas.launches
        draws[mode] = (rng.uniforms.launches, rcam.camera_rays.launches,
                       wp.shade.launches, wp.regenerate.launches)
        loops[mode] = c = loop_counts()
        img = imgs[mode]
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{mode}: bad image")
        total_rad = float(img.double().sum()) * cfg.spp
        rel = abs(total_rad - golden) / golden
        log(f"{mode} final scene {cfg.nx}x{cfg.ny}@{cfg.spp} through K4, "
            f"graphed: radiance sum {total_rad:.1f} vs golden {golden:.1f} "
            f"(rel {rel:.2e}), K4 launches {launches[mode]} ("
            f"{c['warmups']} warm-up block(s), {c['passes']} passes "
            f"replayed, {c['live_passes']} with a live ray), "
            f"{c['replays']} replays, {c['syncs']} host "
            f"reads ({graphed.PASSES_PER_READ} passes a read), K7, K8, K9 "
            f"and K10 launches {', '.join(map(str, draws[mode]))}; "
            f"{capture_note(c)}")
        if launches[mode] < 1:
            raise AssertionError(f"the {mode} render did not launch K4")
        if launches[mode] != c["passes"] + c["warmups"] * \
                graphed.PASSES_PER_READ:
            raise AssertionError(f"{mode}: K4's count is not the passes")
        if draws[mode][2] != launches[mode] or draws[mode][3] != (
                launches[mode] if mode == "regenerative" else 0):
            raise AssertionError(f"{mode}: K9's and K10's counts "
                                 f"{draws[mode][2:]} are not the passes")
        check_reads(mode, c, 1 if mode == "regenerative" else chunks)
        if not rel < 1e-2:
            raise AssertionError(f"{mode}: radiance sum off golden ({rel})")
    diff = float((imgs["regenerative"] - imgs["wavefront"]).abs().max())
    log(f"  regenerative vs wavefront: max |a - b| = {diff:.3e} (bound 2e-6)")
    if not diff <= 2e-6:
        raise AssertionError("regenerative and wavefront images differ")
    mega = mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
    kdiff = (imgs["wavefront"] - mega).abs()
    log(f"  against K1's image: frac(|a-b|>1e-3)="
        f"{float((kdiff > 1e-3).float().mean()):.6f} (logged: the two "
        f"programs round in other orders)")
    del mega, kdiff

    # The graphed frames against the eager ones, ray by ray: radiance and
    # segments.  The eager frames' K4 calls are clocked by events.
    clocks = {mode: Clocked(ip.intersect_pallas,
                            keep=mode == "regenerative")
              for mode in ("regenerative", "wavefront")}

    def pool(**kw):
        return render_rays_regenerative(scene, cam, cfg, key, 0, total, pack,
                                        pool_size=WAVE_RAYS,
                                        return_stats=True, **kw)
    graph_vs_eager("the regenerative frame", pool(),
                   pool(intersect_fn=clocks["regenerative"], graphed=False))
    graph_vs_eager("the wavefront frame", frame_stats(scene, cam, cfg, key,
                                                      pack),
                   frame_stats(scene, cam, cfg, key, pack,
                               clocks["wavefront"], graphed=False))
    segs = frame_stats(scene, cam, cfg, key, pack)[1]
    rays = int(segs.sum())

    # Ray ids [0, 2^17): K4, its plain version and the dense sweep.
    ids = torch.arange(WAVE_RAYS, device=dev)
    r4, s4 = render_ray_batch(scene, cam, cfg, key, ids, pack,
                              return_stats=True)
    rp, sp = render_ray_batch(scene, cam, cfg, key, ids, pack,
                              ip.intersect_pallas_reference,
                              return_stats=True, graphed=False)
    if not (torch.equal(r4, rp) and torch.equal(s4, sp)):
        raise AssertionError("K4's and its plain version's paths differ")
    rb, sb = render_ray_batch(scene, cam, cfg, key, ids, return_stats=True)
    whole = WAVE_RAYS // cfg.spp * cfg.spp  # the rays of whole pixels
    px = lambda r: r[:whole].reshape(-1, cfg.spp, 3).mean(1)  # noqa: E731
    bdiff = (px(r4) - px(rb)).abs()
    frac = float((bdiff > 1e-3).float().mean())
    seg_rel = abs(int(s4.sum()) - int(sb.sum())) / int(sb.sum())
    log(f"  rays [0, {WAVE_RAYS}): K4 (graphed) = its plain version (eager; "
        f"radiance and segments); vs the dense sweep (graphed) over "
        f"{whole // cfg.spp} whole "
        f"pixels frac(|a-b|>1e-3)={frac:.6f}, "
        f"segments {int(s4.sum())} vs {int(sb.sum())} (rel {seg_rel:.2e})")
    if not (frac < 0.01 and seg_rel <= 1e-3):
        raise AssertionError("K4's paths off the dense sweep's")

    # The tape of those rays through K4.
    tape = record_paths_pool(scene, cam, cfg, key, ids, pack,
                             ip.intersect_pallas, pool_size=1 << 14)
    o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
    plain = record_paths(scene, o, d, ids, key, cfg, pack,
                         ip.intersect_pallas_reference, graphed=False)
    if not torch.equal(tape, plain):
        raise AssertionError("the pool tape through K4 differs from the "
                             "plain wavefront record_paths")
    k2b = rm.record_paths_mega(mk.pack_scene_mega(scene), cam, cfg, key,
                               num_rays=WAVE_RAYS)
    tape_agreement("  the pool tape through K4 (= plain record_paths on "
                   "K4's plain version) vs K2b's", tape, k2b, 0.999)
    tape_agreement("  the pool tape through K4 vs the plain record_paths on "
                   "the dense sweep", tape,
                   record_paths(scene, o, d, ids, key, cfg), 0.999)
    del tape, plain, k2b

    # Times: the frames through render_image, eager and graphed in turns
    # (the pool's median of 3 a turn, the chunked frame's one frame a
    # turn: an eager one takes ~18 s); then K4 over a frame and alone.
    sec = {}
    for mode, reps in (("regenerative", 3), ("wavefront", 1)):
        sec[mode] = in_turns(lambda g: frame(mode, g), reps)
        t = sec[mode]
        g = statistics.mean(t["graphed"])
        READINGS[f"{mode} final scene"] = total / min(t["graphed"]) / 1e6
        log(f"{mode}: eager / graphed / graphed / eager s/frame "
            f"{t['eager'][0]:.4f} / {t['graphed'][0]:.4f} / "
            f"{t['graphed'][1]:.4f} / {t['eager'][1]:.4f} ("
            f"{'median of 3' if reps == 3 else 'one frame'} a turn; "
            f"{statistics.mean(t['eager']) / g:.2f}x), graphed "
            f"{total / g / 1e6:.3f} Mpaths/s, {rays / g / 1e6:.3f} "
            f"Mrays/s ({rays} segments); {loops[mode]['syncs']} host reads "
            f"a graphed frame; before K9 and K10 {EARLIER[mode]}; on {card}")
    k4_ms = graph_ms(lambda: ip.intersect_pallas(scene, pack, o, d, 1e-3), 5,
                     20)
    regen_replay_ms = clocks["regenerative"].replay_ms(scene, pack)
    plain_s, _ = host_s(lambda: ip.intersect_pallas_reference(
        scene, pack, o, d, 1e-3))
    b1 = k4_bound(pack, WAVE_RAYS)
    for mode in ("regenerative", "wavefront"):
        c = clocks[mode]
        ms = c.ms()
        fb = k4_bound(pack, c.rays, len(c.events))
        eager_s = statistics.mean(sec[mode]["eager"])
        log(f"  {mode} eager: K4 {len(c.events)} launches over {c.rays} "
            f"rays, {ms:.2f} ms of events around each call per frame "
            f"({ms / len(c.events) * 1e3:.1f} us per launch; bound "
            f"{fb[0]:.3f} ms, {fb[1]}), {ms / 1e3 / eager_s * 100:.2f}% "
            f"of the eager frame")
    log(f"  K4 alone at {WAVE_RAYS} camera rays: {k4_ms:.4f} ms (20 calls in"
        f" a CUDA graph; bound {b1[0]:.4f} ms, {b1[1]}); plain "
        f"{plain_s * 1e3:.1f} ms (one run); over the regenerative frame's "
        f"batches back to back {regen_replay_ms:.2f} ms")
    c = clocks["regenerative"]
    return {"name": "K4 dense closest hit (intersect_pallas), 2^17 rays of "
                    "the final scene",
            "route": "cuda",
            "source": "first_raytracer_tpu_torch/kernels/csrc/intersect.cu",
            "replaces": ip.REPLACES, "launches": launches["regenerative"],
            "launches_wavefront": launches["wavefront"], "max_abs_err": None,
            "ms": k4_ms, "plain_ms": plain_s * 1e3, "bound_ms": b1[0],
            "bound_by": b1[1], "library_ms": None,
            "frame_ms": regen_replay_ms, "frame_events_ms": c.ms(),
            "frame_bound_ms": k4_bound(pack, c.rays, len(c.events))[0],
            "frame_s": sec, "loops": loops, "draw_launches": draws}


FIELD_WAVE = [("field20000", "sphere-field", 20000,
               "radiance_sum_megacluster_field20000_800x450_4spp"),
              ("trifield20000", "triangle-field", 20000,
               "radiance_sum_megacluster_trifield20000_800x450_4spp")]


def clustered_wavefront_path(dev, key, card):
    """Phase 13.  Returns K5's entry of the kernels line and the largest t
    error of K4 against its plain version there."""
    launches, entry, err4 = 0, None, 0.0
    for label, preset, n, gkey in FIELD_WAVE:
        scene, cam, cfg = build_preset(preset, device=dev, n=n)
        pack_s = statistics.median(host_s(
            lambda: ic.pack_scene_clustered(scene))[0] for _ in range(3))
        cpack = ic.pack_scene_clustered(scene)
        chunks = -(-cfg.num_rays // WAVE_RAYS)

        def frame(graphed_=None):
            return render_image(scene, cam, cfg, seed=0,
                                accel=ic.pack_scene_clustered(scene),
                                chunk=WAVE_RAYS, device=dev,
                                graphed=graphed_)

        reset_counts()
        img = frame()
        torch.cuda.synchronize()
        frame_launches = ic.intersect_clustered.launches
        c = loop_counts()
        launches += frame_launches
        if frame_launches < 1 or ip.intersect_pallas.launches:
            raise AssertionError(f"{label}: the frame did not go through K5")
        if frame_launches != c["passes"] + c["warmups"] * \
                graphed.PASSES_PER_READ:
            raise AssertionError(f"{label}: K5's count is not the passes")
        check_reads(label, c, chunks)
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image")
        field_golden(f"{label} {cfg.nx}x{cfg.ny}@{cfg.spp} wavefront "
                     f"through K5, graphed, K5 launches {frame_launches} "
                     f"({c['warmups']} warm-up block(s), {c['passes']} "
                     f"trips replayed, {c['live_passes']} "
                     f"with a live ray, {c['syncs']} host reads; "
                     f"{capture_note(c)})", label, gkey,
                     float(img.double().sum()) * cfg.spp)
        t = in_turns(frame, 3)
        READINGS[f"wavefront {label}"] = cfg.num_rays / min(t["graphed"]) \
            / 1e6
        sec = statistics.mean(t["graphed"])
        clock = Clocked(ic.intersect_clustered, counters=True, keep=True)
        rad5, segs5 = frame_stats(scene, cam, cfg, key, cpack, clock,
                                  graphed=False)
        graph_vs_eager(f"{label}'s frame", frame_stats(scene, cam, cfg, key,
                                                       cpack),
                       (rad5, segs5))
        k5_frame_ms = clock.ms()
        k5_replay_ms = clock.replay_ms(scene, cpack)
        rad_img = rad5.reshape(cfg.ny, cfg.nx, 3).flip(0)
        if not torch.equal(rad_img, img):
            raise AssertionError(f"{label}: the counted frame differs")
        dpack = ip.pack_scene_pallas(scene)
        clock4 = Clocked(ip.intersect_pallas)
        rad4, segs4 = frame_stats(scene, cam, cfg, key, dpack, clock4,
                                  graphed=False)
        diff = (rad5 - rad4).abs()
        frac = float((diff > 1e-3).float().mean())
        differ = int((diff > 0).any(dim=1).sum())
        if preset == "triangle-field":
            seg_bad = float((segs5 != segs4).float().mean())
            seg_note = f"pixels whose segments differ {seg_bad:.6f}"
            seg_ok = seg_bad < 0.01
        else:
            seg_rel = abs(int(segs5.sum()) - int(segs4.sum())) / int(
                segs4.sum())
            seg_note = (f"segments {int(segs5.sum())} vs {int(segs4.sum())}"
                        f" (rel {seg_rel:.2e})")
            seg_ok = seg_rel <= 1e-3
        log(f"  K5 vs K4 frame: frac(|a-b|>1e-3)={frac:.6f}, {differ} pixels"
            f" differ at all, {seg_note}")
        if not (frac < 0.01 and seg_ok):
            raise AssertionError(f"{label}: K5's frame off K4's")
        rays = int(segs5.sum())
        fb = k5_bound(cpack, clock.sweeps.tolist(), clock.rays,
                      len(clock.events))
        tot = clock.sweeps.tolist()
        o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
        k5_ms = graph_ms(lambda: ic.intersect_clustered(scene, cpack, o, d,
                                                        1e-3), 5, 20)
        *_, sw1 = ic.intersect_clustered(scene, cpack, o, d, 1e-3,
                                         return_iters=True)
        b1 = k5_bound(cpack, sw1.long().sum(0).tolist(), WAVE_RAYS)
        plain_s, want = host_s(lambda: ic.intersect_clustered_reference(
            scene, cpack, o, d, 1e-3))
        k5_hits = ic.intersect_clustered(scene, cpack, o, d, 1e-3)
        err = same_hits(f"K5 {label} at {WAVE_RAYS} camera rays", k5_hits,
                        want)
        k4_hits = ip.intersect_pallas(scene, dpack, o, d, 1e-3)
        err4 = max(err4, same_hits(
            f"K4 {label} at {WAVE_RAYS} camera rays", k4_hits,
            ip.intersect_pallas_reference(scene, dpack, o, d, 1e-3)))
        same_hits(f"K5 vs K4 {label} at {WAVE_RAYS} camera rays", k5_hits,
                  k4_hits)
        log(f"  at {WAVE_RAYS} camera rays: K5 = its plain version = K4 = "
            f"its plain version ({int(k4_hits[2].sum())} hits)")
        del k5_hits, k4_hits
        k4_ms = cuda_ms(lambda: ip.intersect_pallas(scene, dpack, o, d,
                                                    1e-3), 3)
        log(f"  eager / graphed / graphed / eager s/frame "
            f"{t['eager'][0]:.4f} / {t['graphed'][0]:.4f} / "
            f"{t['graphed'][1]:.4f} / {t['eager'][1]:.4f} (median of 3 a "
            f"turn, the host pack inside; "
            f"{statistics.mean(t['eager']) / sec:.2f}x), graphed "
            f"{cfg.num_rays / sec / 1e6:.3f} Mpaths/s, "
            f"{rays / sec / 1e6:.3f} Mrays/s ({rays} segments); "
            f"host pack {pack_s:.4f} s; K5 {len(clock.events)} launches over "
            f"{clock.rays} rays, {k5_replay_ms:.2f} ms per frame back to back"
            f" ({k5_frame_ms:.2f} ms of events around each call; bound "
            f"{fb[0]:.3f} ms, {fb[1]}), per ray "
            f"{tot[0] / clock.rays:.2f} clusters swept, "
            f"{tot[1] / clock.rays:.1f} sphere and "
            f"{tot[2] / clock.rays:.1f} triangle slots, "
            f"{tot[3] / clock.rays:.1f} boxes; K4 on the same frame "
            f"{clock4.ms():.2f} ms; before K9 and K10 {EARLIER[label]}; on "
            f"{card}")
        log(f"  at {WAVE_RAYS} camera rays: K5 {k5_ms:.4f} ms (bound "
            f"{b1[0]:.4f} ms, {b1[1]}), plain {plain_s * 1e3:.1f} ms (one "
            f"run), K4 {k4_ms:.4f} ms")
        if label == "field20000":
            entry = {
                "name": "K5 clustered closest hit (intersect_clustered), "
                        "2^17 camera rays of field20000",
                "route": "cuda",
                "source": "first_raytracer_tpu_torch/kernels/csrc/"
                          "intersect.cu",
                "replaces": ic.REPLACES, "max_abs_err": err, "ms": k5_ms,
                "plain_ms": plain_s * 1e3, "bound_ms": b1[0],
                "bound_by": b1[1], "library_ms": None,
                "frame_ms": k5_replay_ms, "frame_events_ms": k5_frame_ms,
                "frame_bound_ms": fb[0], "frame_s": t, "loops": c}
        del rad4, rad5, img, dpack, cpack
        torch.cuda.empty_cache()
    entry["launches"] = launches
    return entry, err4


def free_port():
    """A free TCP port on localhost for a process group's store."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def frame_times(fn):
    """Seconds of one frame (``fn`` and what it queued): median of 3
    after a warm run."""
    fn()
    return statistics.median(host_s(fn)[0] for _ in range(3))


def sharded_one_process(dev, key, card, final_img, field_img):
    """Phase 14: the sharded megakernels under a world-size-1 NCCL group,
    so that their collectives run through NCCL on the card.  Returns the
    slice's launches of K1 and K3."""
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_render_mesh(1, 1)
        gather = mesh.axis(TILE_AXIS)
        launches = {}
        for label, fn, preset, kw, want, counter in (
                ("render_image_mega_sharded", mk.render_image_mega_sharded,
                 "random-spheres", {}, final_img, "K1"),
                ("render_image_mega_clustered_sharded",
                 mc.render_image_mega_clustered_sharded, "sphere-field",
                 dict(n=20000), field_img, "K3")):
            scene, cam, cfg = build_preset(preset, device=dev, **kw)
            reset_counts()
            img = fn(scene, cam, cfg, mesh, seed=0, device=dev)
            torch.cuda.synchronize()
            launches[counter] = (mk.render_pixels_mega.launches
                                 if counter == "K1" else
                                 mc.render_pixels_mega_clustered.launches)
            log(f"  {label} on {preset} {cfg.nx}x{cfg.ny}@{cfg.spp}: "
                f"{counter} launches {launches[counter]}")
            if launches[counter] != 1:
                raise AssertionError(f"{label}: {launches[counter]} "
                                     f"{counter} launches, not 1")
            bit_equal(label, (img.cpu(),), (want,), "the unsharded frame")
            sec = frame_times(lambda: fn(scene, cam, cfg, mesh, seed=0,
                                         device=dev))
            rad = torch.zeros((cfg.num_pixels, 3), device=dev)
            gather_s = frame_times(lambda: gather.all_gather(rad))
            log(f"    {sec:.4f} s/frame median of 3 after a warm run; the "
                f"all-gather of its ({cfg.num_pixels}, 3) f32 pixels "
                f"{gather_s * 1e3:.4f} ms ({gather_s / sec * 100:.3f}% of "
                f"the frame); collectives over {sorted(gather.transports)}; "
                f"on {card}")

        # K3 over 4 pixel ranges of field5000: their concatenation against
        # the whole frame, one range against the plain version's, and one
        # range of trifield20000, where the gate reaches bit-equality.
        for preset, n, exact in (("sphere-field", 5000, False),
                                 ("triangle-field", 20000, True)):
            scene, cam, cfg = build_preset(preset, device=dev, n=n)
            pack = mc.pack_scene_mega_clustered(scene, cam)
            whole, whole_segs = mc.render_pixels_mega_clustered(pack, cam,
                                                                cfg, key)
            P = cfg.num_pixels
            per = -(-P // 4)
            reset_counts()
            parts = [mc.render_pixels_mega_clustered(
                pack, cam, cfg, key, pix0=i * per, num_pixels=per)
                for i in range(4)]
            torch.cuda.synchronize()
            ranges = mc.render_pixels_mega_clustered.launches
            log(f"  K3 over 4 pixel ranges of {per} of {preset}({n}) "
                f"{cfg.nx}x{cfg.ny}@{cfg.spp}: K3 launches {ranges}")
            if ranges != 4:
                raise AssertionError(f"{ranges} K3 launches for 4 ranges")
            launches["K3"] += ranges
            bit_equal("  the ranges, concatenated",
                      (torch.cat([p[0] for p in parts])[:P],
                       torch.cat([p[1] for p in parts])[:P]),
                      (whole, whole_segs), "the whole frame")
            mc.check_clustered_guards(pack, cfg)
            plain_s, (ref, ref_segs) = host_s(lambda: mk.render_reference(
                pack, cam, cfg, key, pix0=per, num_pixels=per,
                rays_per_chunk=PLAIN_PAIRS // pack.sweep_columns))
            rad, segs = parts[1]
            compare_clustered(rad, segs, ref, ref_segs, cfg.spp,
                              f"    range [{per}, {2 * per}) against the "
                              "plain version's", per_pixel=exact)
            differ = int(((rad != ref).any(dim=1) | (segs != ref_segs)).sum())
            log(f"    pixels that differ at all: {differ} of {per} (plain "
                f"version {plain_s * 1e3:.1f} ms, one run)")
            if exact:
                bit_equal("  the range", (rad, segs), (ref, ref_segs),
                          "the plain version's same range")
            del parts, whole, ref
        return launches
    finally:
        dist.destroy_process_group()


def two_processes(dev, card, final_img, field_img, step_single,
                  size="chip"):
    """Phase 15: ``parallel.dryrun`` (the six sharded steps) in two
    processes on the one card, each a rank of a gloo group over a
    localhost store, against this process's frames and step.  Returns the
    slice's launches of K2b and K4 (both ranks)."""
    outdir = os.path.join(ROOT, "out", "phase15")
    shutil.rmtree(outdir, ignore_errors=True)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2")
    cmd = [sys.executable, "-m", "first_raytracer_tpu_torch.parallel.dryrun",
           "--size", size, "--device", dev.type, "--out", outdir]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=dict(env, RANK=str(r),
                                                      LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=480)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-3:]:
            log(f"  rank {r}: {line}")
        if p.returncode != 0:
            log(out[-6000:])
            raise AssertionError(f"phase 15: rank {r} exited "
                                 f"{p.returncode}")
    log(f"  two ranks done in {time.perf_counter() - t0:.1f} s")
    ranks = []
    for r in range(2):
        with np.load(os.path.join(outdir, f"rank{r}.npz")) as f:
            ranks.append({k: f[k] for k in f.files})
    infos = [json.loads(str(r["info"])) for r in ranks]
    log(f"  transports: {infos[0]['transports']} (the compute stays on "
        f"the card: {infos[0]['device']})")
    staged = ("gloo via host tensors" if dev.type == "cuda" else
              "gloo on cpu tensors")
    if not all(i["transports"] == [staged] for i in infos):
        raise AssertionError("phase 15: unexpected transport")

    def equal_on_ranks(what, key, want, against):
        for i, r in enumerate(ranks):
            bit_equal(f"rank {i}: {what}", (torch.from_numpy(r[key]),),
                      (want,), against)

    def launched(step, kernel):
        counts = [i["launches"][step][kernel] for i in infos]
        if not all(counts):
            raise AssertionError(f"phase 15 {step}: {kernel} did not "
                                 f"launch on every rank ({counts})")
        return sum(counts)

    # (a) K1 over pixel ranges of the final scene, 2 x 1.
    equal_on_ranks("render_image_mega_sharded, final scene, 2 x 1", "mega",
                   final_img, "phase 4's frame")
    launched("mega", "K1")
    # (b) K3 over pixel ranges of field20000.
    equal_on_ranks("render_image_mega_clustered_sharded, field20000, 2 x 1",
                   "clustered", field_img, "phase 9's frame")
    launched("clustered", "K3")
    for label in ("mega", "clustered"):
        sec = [statistics.median(r[f"{label}_s"]) for r in ranks]
        gat = [statistics.median(r[f"{label}_gather_s"]) for r in ranks]
        log(f"  {label} sharded frame, 2 ranks sharing the card: "
            f"{sec[0]:.4f} / {sec[1]:.4f} s (median of 3 after a warm run), "
            f"the all-gather alone {gat[0] * 1e3:.3f} / {gat[1] * 1e3:.3f} "
            f"ms ({gat[0] / sec[0] * 100:.2f}% / {gat[1] / sec[1] * 100:.2f}"
            f"% of the frame), gloo via host tensors; on {card}")
    # (c) the wavefront with K4: pixels split bit-equal to one process,
    # samples split within the image bound.
    scene, cam, cfg = dryrun.build("wavefront", size, dev)
    accel = ip.pack_scene_pallas(scene)
    want = render_image(scene, cam, cfg, accel=accel, device=dev).cpu()
    equal_on_ranks("render_image_distributed with K4, 2 x 1",
                   "wavefront_tiles", want, "one process's render_image")
    k4 = launched("wavefront_tiles", "K4") + launched("wavefront_spp", "K4")
    for r in ranks:
        compare(torch.from_numpy(r["wavefront_spp"]).reshape(-1, 3),
                torch.zeros(1), want.reshape(-1, 3), torch.zeros(1), 1,
                "  render_image_distributed with K4, 1 x 2 (spp split)")
    # (d) the ring: the image bound of the replicated render, and the
    # selection of every camera ray equal to the replicated sweep's.
    scene, cam, cfg = dryrun.build("ring", size, dev)
    want = render_image(scene, cam, cfg, device=dev).cpu()
    for r in ranks:
        compare(torch.from_numpy(r["ring"]).reshape(-1, 3), torch.zeros(1),
                want.reshape(-1, 3), torch.zeros(1), 1,
                "  render_image_ring, random-spheres 64x32@2, 2 ranks")
    ids = torch.arange(cfg.num_rays, device=dev)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(rng.base_key(0), ids))
    prim, _, hit = intersect_brute(scene, o, d, cfg.t_min)
    gid = torch.from_numpy(np.concatenate([r["ring_gid"] for r in ranks]))
    prim, hit = prim.cpu(), hit.cpu()
    same = bool(((gid == prim) | ~hit).all()
                and (gid[~hit] == np.iinfo(np.int32).max).all())
    log(f"  ring selection of {cfg.num_rays} camera rays equal to the "
        f"replicated sweep's: {same}")
    if not same:
        raise AssertionError("the ring's selection differs")
    # (e) the record->replay step at 2^17 rays, 2^16 a rank, against phase
    # 6's step on the same rays.
    tape, loss, grads = step_single
    got_tape = torch.from_numpy(np.concatenate(
        [r["replay_tape"] for r in ranks], axis=1))
    bit_equal("  the ranks' K2b tapes, concatenated", (got_tape,), (tape,),
              "phase 6's tape")
    kb = launched("replay", "K2b")

    def replayed(step):
        graphs = [i["graphs"][step] for i in infos]
        log(f"  the ranks' value and gradient in the {step} step: graphs "
            f"{graphs}")
        if dev.type == "cuda" and not all(g["replays"] for g in graphs):
            raise AssertionError(f"phase 15: a rank's {step} step did not "
                                 "replay its graph")
    replayed("replay")
    grads = {k: g.numpy() for k, g in grads.items()}
    for i, r in enumerate(ranks):
        check_step(f"rank {i} record->replay step", r, "replay", loss,
                   grads)
    # The training step (the sharded direct step: each rank records its
    # block and replays its graph of the value and gradient), against one
    # process's direct step on the same rays.
    scene, cam, cfg = dryrun.build("train", size, dev)
    cfg = dataclasses.replace(cfg, differentiable=True)
    params, _ = dg.split_params(scene, fields=dryrun.TRAIN_FIELDS)
    rays = dryrun.REPLAY_RAYS[size] or cfg.num_rays
    ids = torch.arange(rays, device=dev)
    loss, grads = dg.render_loss_and_grads(
        params, scene, cam, cfg, rng.base_key(0), ids,
        torch.zeros((rays, 3), device=dev))
    tape = dg.record_tape(params, scene, cam, cfg, rng.base_key(0), ids)
    got_tape = torch.from_numpy(np.concatenate(
        [r["train_tape"] for r in ranks], axis=1))
    log(f"  the training step: {rays} rays of {cfg.nx}x{cfg.ny}@{cfg.spp}, "
        f"depth {cfg.max_depth}, fields {dryrun.TRAIN_FIELDS}, "
        f"{rays // 2} a rank")
    bit_equal("  the ranks' training-step tapes, concatenated",
              (got_tape,), (tape.cpu(),), "one process's tape")
    replayed("train")
    grads = {k: g.cpu().numpy() for k, g in grads.items()}
    for i, r in enumerate(ranks):
        check_step(f"rank {i} training step", r, "train", loss, grads)
    if dev.type == "cuda":
        for i, r in enumerate(ranks):
            eager, graphed_s = (statistics.median(r[k]) for k in
                                ("train_eager_s", "train_s"))
            log(f"  rank {i} training step, 2 ranks sharing the card "
                f"(median of 3 after a warm run; all 3): op by op "
                f"{eager * 1e3:.1f} ms ("
                f"{', '.join(f'{t * 1e3:.1f}' for t in r['train_eager_s'])}"
                f"), graphed {graphed_s * 1e3:.1f} ms ("
                f"{', '.join(f'{t * 1e3:.1f}' for t in r['train_s'])}), "
                f"{eager / graphed_s:.2f}x; the all-reduce outside the "
                f"graphs, gloo via host tensors; on {card}")
    return {"K2b": kb, "K4": k4}


def grad_spread(got, want):
    """Per field, the largest of |got - want| / (1e-7 + 1e-4 |want|): at
    most 1 within ``rtol=1e-4, atol=1e-7``."""
    return {k: float((np.abs(got[k] - w) / (1e-7 + 1e-4 * np.abs(w))).max())
            if w.size else 0.0 for k, w in want.items()}


def check_step(what, r, prefix, loss, grads):
    """A rank's loss and gradients within ``rtol=1e-4, atol=1e-7`` of one
    process's."""
    got = {k: r[f"{prefix}_grad_{k}"] for k in grads}
    ratios = grad_spread(got, grads)
    ok = bool(np.allclose(r[f"{prefix}_loss"], float(loss), rtol=1e-4,
                          atol=1e-7)) and max(ratios.values()) <= 1.0
    log(f"  {what}: loss {float(r[f'{prefix}_loss']):.9g} vs "
        f"{float(loss):.9g}; per field the largest |a - b| / (1e-7 + 1e-4 "
        f"|b|) {ratios} (bound 1)")
    if not ok:
        raise AssertionError(f"{what} off one process's")


def occupancy_cli(dev, key, card, lane_eff, segments):
    """Phase 16: ``cli occupancy`` in subprocesses on the card, and the
    final scene's path length over its whole frame.

    Held: at full size on the final scene, the megakernel's
    ``lane_occupancy`` against phase 4's lane efficiency and its
    ``mean_path_len`` against phase 4's segments; on three-spheres 24x12 @
    2 (the JAX package's own case, every ray of the frame) both
    megakernels' ``mean_path_len`` within 1e-3 of the wavefront's
    ``avg_path_length``.

    Held too: over the final scene's whole full-size frame, phase 4's
    segments against ``wavefront_occupancy`` on K4 over the same 9.6M rays,
    mean path length within 1e-3 (each side's paths at the depth cap
    logged).  Logged only: the same comparison at 64x32 @ 8 (2^14 rays),
    where one long path moves the mean by more than the bound."""
    def occupancy(*args):
        cmd = [sys.executable, "-m", "first_raytracer_tpu_torch.cli",
               "occupancy", *args]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise AssertionError(f"{' '.join(cmd[1:])} exited "
                                 f"{proc.returncode}")
        return json.loads(proc.stdout)

    scene, cam, cfg = build_preset("random-spheres", device=dev)
    rays = cfg.num_rays
    full = occupancy("--preset", "random-spheres")
    occ = full["megakernel"]["lane_occupancy"]
    mpl = full["megakernel"]["mean_path_len"]
    log(f"  full size: megakernel lane_occupancy {occ} against phase 4's "
        f"lane efficiency {lane_eff:.4f} (bound 1e-3: the warps' steps "
        f"follow the schedule); mean_path_len {mpl} against phase 4's "
        f"{segments / rays:.6f}; clustered lane_occupancy "
        f"{full['megakernel_clustered']['lane_occupancy']}, "
        f"sweeps_per_iter {full['megakernel_clustered']['sweeps_per_iter']}")
    if not (abs(occ - lane_eff) < 1e-3 and mpl == round(segments / rays, 3)):
        raise AssertionError("occupancy's megakernel report is not phase 4's")
    for preset, size, gated in (
            ("three-spheres", ["--nx", "24", "--ny", "12", "--spp", "2"],
             True),
            ("random-spheres", ["--nx", "64", "--ny", "32", "--spp", "8"],
             False)):
        out = occupancy("--preset", preset, *size)
        avg = out["avg_path_length"]
        mk_mpl = out["megakernel"]["mean_path_len"]
        mc_mpl = out["megakernel_clustered"]["mean_path_len"]
        shape = "{}x{}@{}".format(*size[1::2])
        log(f"  {preset} {shape}: megakernel mean_path_len "
            f"{mk_mpl}, clustered {mc_mpl}, wavefront avg_path_length "
            f"{avg:.6f} over the same {out['rays']} rays "
            f"({'bound 1e-3' if gated else 'logged'}); on {card}")
        if gated and not (abs(mk_mpl - avg) < 1e-3
                          and abs(mc_mpl - avg) < 1e-3):
            raise AssertionError("megakernel path length off the "
                                 "wavefront's")
    # The final scene's whole frame: K1's segments (phase 4) against the
    # wavefront's over the same rays, and the paths each traps to the cap.
    t0 = time.perf_counter()
    wave = wavefront_occupancy(scene, cam, cfg, accel=ip.pack_scene_pallas(
        scene), num_rays=rays, device=dev)
    _, trips = rm.record_paths_mega(mk.pack_scene_mega(scene, dev), cam, cfg,
                                    key, return_iters=True)
    capped = int((trips == cfg.max_depth + 1).sum())
    if int(trips.sum()) != segments:
        raise AssertionError("K2b's trips over the frame are not K1's "
                             "segments")
    seconds = time.perf_counter() - t0
    gap = segments / rays - wave["avg_path_length"]
    log(f"  random-spheres whole frame ({rays} rays): K1's mean path length "
        f"{segments / rays:.6f}, the wavefront's (K4) "
        f"{wave['avg_path_length']:.6f}, difference {gap:.3e} (bound "
        f"1e-3); paths at the depth cap: K2b {capped}, the wavefront "
        f"{wave['alive_per_bounce'][-1]} ({seconds:.1f} s); on {card}")
    if not abs(gap) < 1e-3:
        raise AssertionError("K1's mean path length over the final scene "
                             "off the wavefront's")


def eager_direct(params, scene, cam, cfg, key, ids, target, accel=None,
                 record_pool=0):
    """The direct step op by op: ``record_tape`` with ``graphed=False`` and
    the eager body ``tape_loss_and_grads``.  Returns (tape, (loss,
    grads))."""
    tape = dg.record_tape(params, scene, cam, cfg, key, ids, accel,
                          record_pool=record_pool, graphed=False)
    return tape, dg.tape_loss_and_grads(params, scene, cam, key, ids, target,
                                        tape, cfg=cfg)


def direct_against_eager(what, params, scene, cam, cfg, key, ids, target,
                         accel=None):
    """The direct step through the user's entry point,
    ``render_loss_and_grads`` (the recorder's loop and the whole tape's
    value and gradient replayed as CUDA graphs), against ``eager_direct``
    on the same inputs: the tapes ``torch.equal``, the loss within one
    float32 ulp and every gradient within ``rtol=1e-6``.  The loop's
    counters and K4's and K5's launches are reset just before the graphed
    step and read just after it.  Returns the graphed step's tape, loss,
    gradients, its loop counters, launches and captures, and the eager
    step's seconds."""
    eager_s, (tape_e, (loss_e, grads_e)) = host_s(lambda: eager_direct(
        params, scene, cam, cfg, key, ids, target, accel))
    captures = dg.GRAPHS.captures
    reset_counts()
    first_s, (loss, grads) = host_s(lambda: dg.render_loss_and_grads(
        params, scene, cam, cfg, key, ids, target, accel))
    counts = loop_counts()
    launches = {"K4": ip.intersect_pallas.launches,
                "K5": ic.intersect_clustered.launches}
    replay_capture = dg.GRAPHS.last if dg.GRAPHS.captures > captures \
        else None
    tape = dg.record_tape(params, scene, cam, cfg, key, ids, accel)
    ulp = float(np.spacing(np.float32(abs(float(loss_e)))))
    dl = abs(float(loss) - float(loss_e))
    ratio = max(float(((g - grads_e[k]).abs()
                       / (1e-6 * grads_e[k].abs())).nan_to_num(0.0).max())
                for k, g in grads.items() if g.numel())
    log(f"  {what}: graph against eager: tape equal "
        f"{torch.equal(tape, tape_e)}, loss {float(loss):.9g} vs "
        f"{float(loss_e):.9g} (|a - b| {dl:.3g}, one ulp {ulp:.3g}); "
        f"gradients' largest |a - b| / (1e-6 |b|) {ratio:.4g} (bound 1); "
        f"the first graphed step {first_s:.3f} s (its captures), eager "
        f"{eager_s:.3f} s; the recorder's loop {counts['passes']} passes "
        f"({counts['live_passes']} live) in {counts['replays']} replays, "
        f"{counts['syncs']} flag reads; launches {launches}")
    if not torch.equal(tape, tape_e):
        raise AssertionError(f"{what}: the graphed tape differs from the "
                             "eager one")
    if not (dl <= ulp and ratio <= 1.0):
        raise AssertionError(f"{what}: the graphed step is off its eager "
                             "body")
    check_reads(what, counts, 1)
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite gradient {k}")
    return dict(tape=tape, loss=loss, grads=grads, counts=counts,
                launches=launches, eager_s=eager_s,
                loop_capture=counts["capture"],
                replay_capture=replay_capture)


def direct_turns(what, fns, card):
    """Seconds of each pair of ``fns`` ((eager, graphed) by name) in turns,
    eager, graphed, graphed, eager; logs and returns {name: [s, s]}."""
    times = {k: [] for k in fns}
    for pair in (("eager step", "graphed step"),
                 ("eager recorder", "graphed recorder"),
                 ("eager replay", "graphed replay")):
        for k in (*pair, *pair[::-1]):
            times[k].append(host_s(fns[k])[0])
    log(f"  {what}, in turns (eager, graphed, graphed, eager): "
        + "; ".join(f"{k} {', '.join(f'{t * 1e3:.1f}' for t in v)} ms"
                    for k, v in times.items())
        + f"; before K11-K13 {EARLIER[what]}; on {card}")
    return times


def direct_step_path(dev, key, card):
    """Phase 18.  The direct gradient step (``cli fit`` without
    ``--fast``, JAX's jitted ``render_loss_and_grads``) at 2^17 rays.
    Returns K4's and K5's launches on it for the kernels line, and the
    final scene's dense-sweep tape (phase 19 holds K6's to it) and its
    step's loss and gradients (phase 20 holds the scan to them)."""
    R = GRAD_RAYS
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    params, _ = dg.split_params(scene)
    d = direct_against_eager("final scene, dense sweep", params, scene, cam,
                             cfg, key, ids, target)
    tape = d["tape"]

    # Against the JAX package's golden: its recorder is the lockstep
    # record_paths this step replays.
    with open(GRAD_GOLDEN) as f:
        golden = json.load(f)
    with np.load(GRAD_GOLDEN_TAPE) as saved:
        jax_tape = torch.from_numpy(saved["tape"].astype(np.int32)).to(dev)
    rows = (tape >= 0).sum(dim=1).tolist()
    row_diff = [a - b for a, b in zip(rows, golden["tape"]["hits_per_row"])]
    log(f"  hits per row against the golden's (JAX's record_paths): "
        f"differences {row_diff}, largest {max(map(abs, row_diff))}")
    tape_agreement("  the direct step's tape vs JAX's", tape, jax_tape,
                   0.999)
    rel = abs(float(d["loss"]) - golden["loss"]) / golden["loss"]
    log(f"  loss {float(d['loss']):.9g} against the golden's "
        f"{golden['loss']:.9g}: rel {rel:.3e} (bound 1e-2)")
    if not rel < 1e-2:
        raise AssertionError(f"the direct step's loss off the golden by "
                             f"{rel:.3g}")
    check_grads("direct step", {"albedo": d["grads"]["albedo"]},
                {"albedo": golden["fields"]["albedo"]["values"]},
                lambda k: 0.05)

    def eager_step():
        return eager_direct(params, scene, cam, cfg, key, ids, target)

    fns = {
        "eager step": eager_step,
        "graphed step": lambda: dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target),
        "eager recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids, graphed=False),
        "graphed recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids),
        "eager replay": lambda: dg.tape_loss_and_grads(
            params, scene, cam, key, ids, target, tape, cfg=cfg),
        "graphed replay": lambda: dg.render_loss_and_grads_tape(
            params, scene, cam, cfg, key, ids, target, tape),
    }
    times = direct_turns("final scene, dense sweep", fns, card)
    peaks = {}
    for k in ("eager step", "graphed step"):
        torch.cuda.reset_peak_memory_stats()
        host_s(fns[k])
        peaks[k] = torch.cuda.max_memory_allocated() / 1e9
    loop_cap, replay_cap = d["loop_capture"], d["replay_capture"]
    log(f"  captures: the recorder's loop warm-up "
        f"{loop_cap['warmup_s']:.3f} s, capture {loop_cap['capture_s']:.3f}"
        f" s, pool {loop_cap['pool_bytes'] / 1e9:.3f} GB; the replay's "
        + (f"warm-up {replay_cap['warmup_s']:.3f} s, capture "
           f"{replay_cap['capture_s']:.3f} s, pool "
           f"{replay_cap['pool_bytes'] / 1e9:.3f} GB" if replay_cap
           else "graph was cached")
        + f"; peak memory allocated in a step: eager "
        f"{peaks['eager step']:.3f} GB, graphed {peaks['graphed step']:.3f}"
        f" GB; on {card}")

    # The pool recorder (2^14 slots) gives the lockstep recorder's tape.
    pool_s, pool = host_s(lambda: dg.record_tape(
        params, scene, cam, cfg, key, ids, record_pool=1 << 14))
    pool_s = host_s(lambda: dg.record_tape(
        params, scene, cam, cfg, key, ids, record_pool=1 << 14))[0]
    log(f"  the pool recorder (2^14 slots): tape equal to the lockstep "
        f"recorder's {torch.equal(pool, tape)} ({pool_s * 1e3:.1f} ms "
        f"graphed, its second call; before K11-K13 "
        f"{EARLIER['pool recorder']})")
    if not torch.equal(pool, tape):
        raise AssertionError("the pool recorder's tape differs from the "
                             "lockstep recorder's")
    del pool

    # K4: the direct step on the Pallas pack, and its pool recorder.
    pack4 = ip.pack_scene_pallas(scene)
    d4 = direct_against_eager("final scene, K4", params, scene, cam, cfg,
                              key, ids, target, pack4)
    tape_agreement("  the K4 tape vs the dense sweep's", d4["tape"], tape,
                   0.999)
    pool4 = dg.record_tape(params, scene, cam, cfg, key, ids, pack4,
                           record_pool=1 << 14)
    if not torch.equal(pool4, d4["tape"]):
        raise AssertionError("the pool recorder's tape through K4 differs "
                             "from the lockstep recorder's")
    log("  the pool recorder through K4 (2^14 slots): tape equal to the "
        "lockstep recorder's")
    k4_launches = d4["launches"]["K4"]
    dense_tape, dense_step = tape, (d["loss"], d["grads"])
    del d, d4, pool4, tape, fns, pack4, jax_tape
    torch.cuda.empty_cache()

    # K5 on field5000.
    scene, cam, cfg = build_preset("sphere-field", device=dev, n=5000)
    params, _ = dg.split_params(scene)
    pack5 = ic.pack_scene_clustered(scene)
    d5 = direct_against_eager("field5000, K5", params, scene, cam, cfg, key,
                              ids, target, pack5)
    k3t = rm.record_paths_mega_clustered(
        mc.pack_scene_mega_clustered(scene, cam), cam, cfg, key, num_rays=R)
    agree = float((d5["tape"] == k3t).float().mean())
    log(f"  field5000: the direct step's tape (K5) vs K3t's (phase 10's "
        f"recorder): agreement {agree:.6f}, "
        f"{int((d5['tape'] != k3t).any(dim=0).sum())} rays differ (logged: "
        "the float32 wavefront re-hits far spheres, phase 10)")
    tape5 = d5["tape"]
    fns5 = {
        "eager step": lambda: eager_direct(params, scene, cam, cfg, key,
                                           ids, target, pack5),
        "graphed step": lambda: dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target, pack5),
        "eager recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids, pack5, graphed=False),
        "graphed recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids, pack5),
        "eager replay": lambda: dg.tape_loss_and_grads(
            params, scene, cam, key, ids, target, tape5, cfg=cfg),
        "graphed replay": lambda: dg.render_loss_and_grads_tape(
            params, scene, cam, cfg, key, ids, target, tape5),
    }
    times5 = direct_turns("field5000, K5", fns5, card)
    if not (k4_launches > 0 and d5["launches"]["K5"] > 0):
        raise AssertionError("the direct step did not launch K4 or K5")
    return dict(times=times, times5=times5, peaks=peaks, tape=dense_tape,
                step=dense_step,
                launches={"K4": k4_launches, "K5": d5["launches"]["K5"]})


# Phase 19: K6, the flat-BVH walk, on the graft entry's BVH (the final
# scene, ``build_bvh(max_leaf=4)``) and on triangle scenes.
BVH_MAX_LEAF = 4


def walk_sets(dev, key, scene, bvh, cam, cfg, o, d):
    """The ray sets phase 19 holds K6 to its plain version on: (label,
    scene, BVH, origin, direction).  The final scene's 2^17 camera rays and
    one bounce's secondary rays from their hits (``scatter`` at bounce 0);
    field5000's, field20000's and trifield20000's 2^17 camera rays, and
    trifield20000's on its triangles alone; the triangle-mesh preset's
    (triangles and spheres)."""
    ids = torch.arange(o.shape[0], device=dev)
    prim, _, hit = traverse.intersect_bvh(scene, bvh, o, d, 1e-3)
    _, p, n, mat = recompute_hit(scene, o, d, prim, 1e-3)
    new_d, _, ok = scatter(scene, mat, d, p, n,
                           rng.bounce_uniforms(key, ids, 0))
    live = hit & ok
    sets = [("final scene, 2^17 camera rays", scene, bvh, o, d),
            ("final scene, one bounce's secondary rays", scene, bvh,
             p[live].contiguous(), new_d[live].contiguous())]
    for label, preset, n_prims in (("field5000", "sphere-field", 5000),
                                   ("field20000", "sphere-field", 20000)):
        field, fcam, fcfg = build_preset(preset, device=dev, n=n_prims)
        sets.append((f"{label}, 2^17 camera rays", field,
                     build_bvh(field, max_leaf=BVH_MAX_LEAF),
                     *camera_rays(field, fcam, fcfg, key, WAVE_RAYS)))
    field, fcam, fcfg = build_preset("triangle-field", device=dev, n=20000)
    tris = dataclasses.replace(field, sphere_center=field.sphere_center[:0],
                               sphere_radius=field.sphere_radius[:0],
                               sphere_mat=field.sphere_mat[:0])
    fo, fd = camera_rays(field, fcam, fcfg, key, WAVE_RAYS)
    sets.append(("trifield20000, 2^17 camera rays", field,
                 build_bvh(field, max_leaf=BVH_MAX_LEAF), fo, fd))
    sets.append(("trifield20000's triangles alone, 2^17 camera rays", tris,
                 build_bvh(tris, max_leaf=BVH_MAX_LEAF), fo, fd))
    mesh, mcam, mcfg = build_preset("triangle-mesh", device=dev)
    sets.append(("triangle-mesh (triangles and spheres), its "
                 f"{mcfg.num_rays} camera rays", mesh,
                 build_bvh(mesh, max_leaf=BVH_MAX_LEAF),
                 *camera_rays(mesh, mcam, mcfg, key, mcfg.num_rays)))
    return sets


def bvh_builds(dev, card):
    """``build_bvh(max_leaf=4)`` of the final scene, field5000, field20000
    and trifield20000 (their scenes on the card), native and NumPy: host
    seconds, median of 3, the copy of the scene to the host and of the
    arrays to the card included.  Returns {scene: {backend: s}}."""
    out = {}
    for label, preset, kw in (("final scene", "random-spheres", {}),
                              ("field5000", "sphere-field", {"n": 5000}),
                              ("field20000", "sphere-field", {"n": 20000}),
                              ("trifield20000", "triangle-field",
                               {"n": 20000})):
        sc = build_preset(preset, device=dev, **kw)[0]
        out[label] = {b: statistics.median(
            host_s(lambda: build_bvh(sc, max_leaf=BVH_MAX_LEAF,
                                     backend=b))[0] for _ in range(3))
            for b in ("native", "numpy")}
        bv = build_bvh(sc, max_leaf=BVH_MAX_LEAF)
        log(f"  build_bvh(max_leaf {BVH_MAX_LEAF}) of {label}: "
            f"{bv.num_nodes} nodes, {bv.prim_ids.shape[0]} slots; native "
            f"{out[label]['native']:.4f} s, NumPy {out[label]['numpy']:.4f}"
            f" s (host, median of 3); on {card}")
    return out


def sync_count(fn):
    """Synchronizing CUDA calls that ``fn`` makes after a warm call, as
    ``torch.cuda.set_sync_debug_mode("warn")`` counts them: (count, the
    source lines that made them)."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # torch's one-time notice that the mode is a prototype mentions
    # synchronization too; only the warnings of a synchronizing call count.
    found = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(found), sorted({f"{os.path.relpath(w.filename, ROOT)}:"
                               f"{w.lineno}" for w in found})


def bvh_cli(card):
    """``cli render --mode regenerative --bvh`` at 120x80 @ 4 in a
    subprocess: it exits 0 and its loops were captured and replayed."""
    out = os.path.join(ROOT, "out", "bvh_cli.png")
    cmd = [sys.executable, "-m", "first_raytracer_tpu_torch.cli", "render",
           "--preset", "random-spheres", "--nx", "120", "--ny", "80",
           "--spp", "4", "--mode", "regenerative", "--bvh", "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                  PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cli render --bvh exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"  {' '.join(cmd[3:])} in {time.perf_counter() - t0:.1f} s of "
        f"process: {line}")
    loops = line.split("loops: ", 1)[-1].split(", ")
    counts = {k.split()[1]: int(k.split()[0]) for k in loops}
    if "cuda" not in line or not (counts.get("captures", 0) >= 1
                                  and counts.get("replays", 0) >= 1):
        raise AssertionError("cli render --bvh did not replay graphs on the "
                             "card")


def walk_against_plain(dev, key, card, scene, bvh, cam, cfg, o, d):
    """K6 against its plain version on ``walk_sets``, bit for bit and visit
    for visit (the per-ray counters): through the path each scene takes,
    and through the other one forced where a block can hold the staged
    bytes; each set of 2^17 rays timed through each.  Returns (the largest
    t difference, {set: times})."""
    err = 0.0
    set_ms = {}
    smem_limit = getattr(torch.cuda.get_device_properties(dev),
                         "shared_memory_per_block_optin", 232448)
    for label, sc, bv, so, sd in walk_sets(dev, key, scene, bvh, cam, cfg,
                                           o, d):
        path = traverse.walk_path(sc, bv)
        before = traverse.intersect_bvh.launches
        got = traverse.intersect_bvh(sc, bv, so, sd, 1e-3,
                                     return_counters=True)
        torch.cuda.synchronize()
        if traverse.intersect_bvh.launches != before + 1:
            raise AssertionError("K6's launch counter did not move")
        want = traverse.intersect_bvh_plain(sc, bv, so, sd, 1e-3,
                                            return_counters=True)
        what = (f"K6 {label} ({so.shape[0]} rays, {int(got[2].sum())} "
                f"hits; {bv.num_nodes} nodes, "
                f"{traverse.shared_bytes(sc, bv)} bytes staged")
        bit_equal(f"{what}, {path} path) (prim, t, hit, counters)", got,
                  want)
        runs = {path: lambda: traverse.intersect_bvh(sc, bv, so, sd, 1e-3)}
        # The other path, forced, where a block can hold the staged bytes.
        other, budget = (("global", 0) if path == "shared" else
                         ("shared", 2 ** 31 - 1))
        if traverse.shared_bytes(sc, bv) <= smem_limit:
            forced = traverse._launch_cuda(sc, bv, so, sd, 1e-3,
                                           BVH_MAX_LEAF, True, budget)
            bit_equal(f"{what}, the {other} path forced)", forced, want)
            runs[other] = lambda: traverse._launch_cuda(
                sc, bv, so, sd, 1e-3, BVH_MAX_LEAF, False, budget)
        err = max(err, float((got[1] - want[1]).abs().max()))
        if so.shape[0] < GRAD_RAYS // 2:
            continue
        sums = want[3].long().sum(0).tolist()
        b = k6_bound(sc, bv, sums, so.shape[0])
        times = {p: graph_ms(fn, 5, 20) for p, fn in runs.items()}
        set_ms[label] = {"ms": times, "bound_ms": b[0], "path": path}
        log(f"  K6 {label}: " + ", ".join(
            f"{p} path {ms:.5f} ms" for p, ms in times.items())
            + f" (20 calls in a CUDA graph; bound {b[0]:.5f} ms, {b[1]}; per"
            f" ray {sums[0] / so.shape[0]:.2f} nodes, "
            f"{sums[1] / so.shape[0]:.2f} sphere and "
            f"{sums[2] / so.shape[0]:.2f} triangle slots); default path "
            f"{path}; before the warp walk "
            f"{EARLIER_K6.get(label, 'not measured')}; on {card}")
    return err, set_ms


def bvh_walk_path(dev, key, card, dense_tape):
    """Phase 19.  Returns K6's entry of the kernels line."""
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    bvh = build_bvh(scene, max_leaf=BVH_MAX_LEAF)
    leaves = bvh.node_count > 0
    log(f"final scene BVH (build_bvh max_leaf {BVH_MAX_LEAF}): "
        f"{bvh.num_nodes} nodes, {int(leaves.sum())} leaves")
    o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
    ids = torch.arange(WAVE_RAYS, device=dev)

    err, set_ms = walk_against_plain(dev, key, card, scene, bvh, cam, cfg,
                                     o, d)
    builds = bvh_builds(dev, card)

    # Against the dense sweep: the same winner but on exact ties.
    k6 = traverse.intersect_bvh(scene, bvh, o, d, 1e-3)
    brute = intersect_brute(scene, o, d, 1e-3)
    differ = k6[0] != brute[0]
    ties = differ & (k6[1] == brute[1])
    log(f"  K6 vs the dense sweep on the 2^17 camera rays: hits equal "
        f"{torch.equal(k6[2], brute[2])}, {int(differ.sum())} primitives "
        f"differ, {int(ties.sum())} of them exact ties in t")
    if not torch.equal(k6[2], brute[2]) or bool((differ & ~ties).any()):
        raise AssertionError("K6's winners differ from the dense sweep's "
                             "off exact ties")

    # Host syncs inside one call, K6 against its plain version.
    syncs, where = sync_count(lambda: traverse.intersect_bvh(scene, bvh, o,
                                                             d, 1e-3))
    plain_syncs, _ = sync_count(lambda: traverse.intersect_bvh_plain(
        scene, bvh, o, d, 1e-3))
    log(f"  syncs in a call (torch.cuda.set_sync_debug_mode): K6 {syncs} "
        f"{where}, the plain walk {plain_syncs}")
    if syncs:
        raise AssertionError(f"K6's call made {syncs} host syncs")

    # The graft entry's forward step, graphed, against the plain walk.
    fn, args = entry(dev)
    reset_counts()
    first_s, out1 = host_s(lambda: fn(*args))
    out2 = fn(*args)
    torch.cuda.synchronize()
    entry_launches, c = traverse.intersect_bvh.launches, loop_counts()
    scene_e, cam_e, key_e, ids_e, bvh_e = args
    cfg_e = random_scene(nx=128, ny=64, spp=2, device=dev)[2]

    def plain_entry():
        return render_ray_batch(scene_e, cam_e, cfg_e, key_e, ids_e, bvh_e,
                                traverse.intersect_bvh_plain, graphed=False)
    eager_s, plain = host_s(plain_entry)
    graphed_s = host_s(lambda: fn(*args))[0]
    log(f"  entry() (8192 rays of the final scene at 128x64 @ 2, depth 50):"
        f" graphed twice, equal {torch.equal(out1, out2)}, equal to the "
        f"plain walk's eager forward {torch.equal(out1, plain)}; K6 "
        f"launches {entry_launches} ({c['passes']} passes, {c['replays']} "
        f"replays, {c['syncs']} flag reads); {capture_note(c)}; s: first "
        f"(its capture) {first_s:.3f}, graphed {graphed_s:.4f} (before K9 "
        f"and K10 {EARLIER['entry']}; before the warp walk "
        f"{EARLIER_K6['entry']}), "
        f"the plain walk eager {eager_s:.3f}; "
        f"on {card}")
    if not (torch.equal(out1, out2) and torch.equal(out1, plain)):
        raise AssertionError("entry()'s graphed forward differs from the "
                             "plain walk's")
    if not (entry_launches > 0 and c["replays"] > 0):
        raise AssertionError("entry() did not replay graphs through K6")
    del out1, out2, plain

    # The lockstep recorder through K6 against phase 18's dense sweep.
    rec_s, tape6 = host_s(lambda: record_paths(scene, o, d, ids, key, cfg,
                                               bvh))
    rec_s2 = host_s(lambda: record_paths(scene, o, d, ids, key, cfg, bvh))[0]
    log(f"  the lockstep recorder through K6 at 2^17 rays: {rec_s:.3f} s "
        f"(its capture), {rec_s2:.4f} s graphed (before K9 and K10 "
        f"{EARLIER['bvh recorder']}); "
        f"{int((tape6 != dense_tape).sum())} of {tape6.numel()} entries "
        "differ from phase 18's dense-sweep tape")
    tape_agreement("  K6's lockstep tape vs the dense sweep's", tape6,
                   dense_tape, 0.999)
    del tape6

    # The main path: the full-width pool frame through K6; counters reset
    # just before it, read just after.
    golden = final_golden()
    pack4 = ip.pack_scene_pallas(scene)

    def frame(accel):
        return render_image(scene, cam, cfg, seed=0, accel=accel,
                            mode="regenerative", pool_size=WAVE_RAYS,
                            device=dev)
    reset_counts()
    img6 = frame(bvh)
    torch.cuda.synchronize()
    launches, c6 = traverse.intersect_bvh.launches, loop_counts()
    if tuple(img6.shape) != (cfg.ny, cfg.nx, 3) or \
            not bool(torch.isfinite(img6).all()):
        raise AssertionError("the K6 frame: bad image")
    total_rad = float(img6.double().sum()) * cfg.spp
    rel = abs(total_rad - golden) / golden
    log(f"regenerative final scene {cfg.nx}x{cfg.ny}@{cfg.spp} through K6, "
        f"graphed: radiance sum {total_rad:.1f} vs golden {golden:.1f} (rel "
        f"{rel:.2e}), K6 launches {launches} ({c6['warmups']} warm-up "
        f"block(s), {c6['passes']} passes replayed, {c6['live_passes']} "
        f"with a live ray), {c6['replays']} replays, {c6['syncs']} host "
        f"reads; {capture_note(c6)}")
    if launches < 1 or launches != c6["passes"] + c6["warmups"] * \
            graphed.PASSES_PER_READ:
        raise AssertionError("the K6 frame's launches are not its passes")
    check_reads("the K6 frame", c6, 1)
    if not rel < 1e-2:
        raise AssertionError(f"the K6 frame's radiance sum off golden ({rel})")
    img4 = frame(pack4)
    kdiff = (img6 - img4).abs()
    log(f"  against the same frame through K4: frac(|a-b|>1e-3)="
        f"{float((kdiff > 1e-3).float().mean()):.6f}, max "
        f"{float(kdiff.max()):.3e} (logged: the two kernels sum their dot "
        "products in other orders)")
    del img4, kdiff
    turns = {"K4": [], "K6": []}
    for label in ("K4", "K6", "K6", "K4"):
        accel = pack4 if label == "K4" else bvh
        turns[label].append(statistics.median(
            host_s(lambda: frame(accel))[0] for _ in range(3)))
    total = cfg.num_rays
    log(f"  s/frame in turns (K4, K6, K6, K4; median of 3 a turn): K4 "
        f"{turns['K4'][0]:.4f}, {turns['K4'][1]:.4f}; K6 "
        f"{turns['K6'][0]:.4f}, {turns['K6'][1]:.4f} "
        f"({total / min(turns['K6']) / 1e6:.3f} Mpaths/s); before K9 and "
        f"K10 {EARLIER['bvh frame']}; before the warp walk "
        f"{EARLIER_K6['bvh frame']}; "
        f"on {card}")

    # The same frame op by op, K6 clocked by events around each call:
    # graphed = eager, and K6's time and work over the frame.
    clock = Clocked(traverse.intersect_bvh, keep=True)

    def pool(**kw):
        return render_rays_regenerative(scene, cam, cfg, key, 0, total, bvh,
                                        pool_size=WAVE_RAYS,
                                        return_stats=True, **kw)
    graph_vs_eager("the regenerative frame through K6", pool(),
                   pool(intersect_fn=clock, graphed=False))
    walk = torch.zeros(3, dtype=torch.int64, device=dev)
    for bo, bd, bt in clock.batches:
        walk += traverse.intersect_bvh(scene, bvh, bo, bd, bt,
                                       return_counters=True)[3].long().sum(0)
    frame_bound = k6_bound(scene, bvh, walk.tolist(), clock.rays,
                           len(clock.events))
    frame_ms = clock.replay_ms(scene, bvh)

    # K6 alone at 2^17 camera rays.
    k6_ms = graph_ms(lambda: traverse.intersect_bvh(scene, bvh, o, d, 1e-3),
                     5, 20)
    plain_s, _ = host_s(lambda: traverse.intersect_bvh_plain(
        scene, bvh, o, d, 1e-3))
    counts = traverse.intersect_bvh(scene, bvh, o, d, 1e-3,
                                    return_counters=True)[3].long()
    sums = counts.sum(0).tolist()
    b1 = k6_bound(scene, bvh, sums, WAVE_RAYS)
    log(f"  K6 alone at {WAVE_RAYS} camera rays: {k6_ms:.4f} ms (20 calls in"
        f" a CUDA graph; bound {b1[0]:.4f} ms, {b1[1]}: per ray "
        f"{sums[0] / WAVE_RAYS:.2f} nodes (at most {int(counts[:, 0].max())})"
        f", {sums[1] / WAVE_RAYS:.2f} sphere slots); plain "
        f"{plain_s * 1e3:.1f} ms (one run, {plain_syncs} syncs); over the "
        f"frame's {len(clock.events)} calls ({clock.rays} rays) back to back "
        f"{frame_ms:.2f} ms (bound {frame_bound[0]:.3f} ms, "
        f"{frame_bound[1]}; before the warp walk "
        f"{EARLIER_K6['frame calls']}), "
        f"events around the eager calls {clock.ms():.2f} ms; path "
        f"{traverse.walk_path(scene, bvh)}; on {card}")
    bvh_cli(card)
    return {"name": "K6 flat-BVH walk (intersect_bvh), 2^17 camera rays of "
                    "the final scene",
            "route": "cuda",
            "source": "first_raytracer_tpu_torch/kernels/csrc/bvh_walk.cu",
            "replaces": traverse.REPLACES, "launches": launches,
            "max_abs_err": err, "ms": k6_ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b1[0], "bound_by": b1[1], "library_ms": None,
            "entry_launches": entry_launches, "frame_ms": frame_ms,
            "frame_bound_ms": frame_bound[0], "frame_s": turns,
            "entry_s": {"graphed": graphed_s, "plain_eager": eager_s},
            "syncs": syncs, "path": traverse.walk_path(scene, bvh),
            "sets": set_ms, "bvh_build_s": builds}


def graph_nodes(fn):
    """Nodes of a CUDA graph of one call of ``fn``, as ``cuGraphGetNodes``
    counts them on the graph torch keeps with ``keep_graph``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return count.value


def last_pool_pass(scene, cam, cfg, key, pack):
    """The final scene's pool frame (2^17 slots through K4) op by op: the
    ids, depths and live slots at the start of its last pass with a live
    slot, and its passes."""
    dev = scene.device
    inputs = dict(scene=scene, camera=cam, accel=pack, key=key,
                  start_id=torch.zeros((), dtype=torch.int64, device=dev))
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=WAVE_RAYS,
                  intersect_fn=ip.intersect_pallas)
    state = pool_state(**inputs, **static)
    passes = 0
    while bool(state["alive"].any()):
        last = (state["ids"].clone(), state["depth"].clone(),
                state["alive"].clone())
        pool_pass(state, **inputs, **static)
        passes += 1
    return (*last, passes)


def scan_turns(fns, card):
    """Seconds of the eager and the graphed scan in turns, eager, graphed,
    graphed, eager, and the peak memory allocated in one call of each;
    logs and returns both."""
    times = {k: [] for k in fns}
    for k in ("eager scan", "graphed scan", "graphed scan", "eager scan"):
        times[k].append(host_s(fns[k])[0])
    peaks = {}
    for k in fns:
        torch.cuda.reset_peak_memory_stats()
        host_s(fns[k])
        peaks[k] = torch.cuda.max_memory_allocated()
    speedup = (statistics.mean(times["eager scan"])
               / statistics.mean(times["graphed scan"]))
    log(f"  the scan in turns (eager, graphed, graphed, eager): "
        + "; ".join(f"{k} {', '.join(f'{t * 1e3:.1f}' for t in v)} ms"
                    for k, v in times.items())
        + f" ({speedup:.2f}x); peak memory allocated in a call: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in peaks.items())
        + f"; on {card}")
    return times, peaks


def scan_path(params, scene, cam, cfg, key, ids, target, replay_step, card):
    """The differentiable scan (``method="scan"``, the JAX package's jitted
    ``render_loss_and_grads`` with ``method`` static) through the user's
    entry point, a replay of its captured graph (``dg.SCAN_GRAPHS``):
    captured on its first call (warm-up and capture seconds, pool bytes,
    the peak memory allocated meanwhile); counters reset just before its
    second call and read just after: K8 once, K7 (the draw) and K11 (the
    closest hit, given the rays' liveness mask) once a trip.  Held to the
    eager body (``scan_loss_and_grads``) on the same inputs, the loss
    within one float32 ulp and every gradient within ``rtol=1e-6``, every
    gradient finite; and to ``replay_step`` (the replay's (loss, grads) on
    the same rays) within tests/test_torch_replay.py's
    ``test_replay_matches_scan`` bounds: loss ``rtol=1e-6``, gradients
    ``rtol=2e-3, atol=1e-7``.  Then timed in turns with the eager body.
    Returns K7's launches and the readings."""
    def graphed_scan():
        return dg.render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                        target, method="scan")

    def eager_scan():
        return dg.scan_loss_and_grads(params, scene, cam, key, ids, target,
                                      None, cfg=cfg,
                                      intersect_fn=default_intersect)

    R, trips = ids.shape[0], cfg.max_depth + 1
    captures = dg.SCAN_GRAPHS.captures
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first_s = host_s(graphed_scan)[0]
    capture_peak = torch.cuda.max_memory_allocated() - base
    if dg.SCAN_GRAPHS.captures != captures + 1:
        raise AssertionError("the scan's first call did not capture")
    cap = dg.SCAN_GRAPHS.last
    reset_counts()
    loss, grads = graphed_scan()
    torch.cuda.synchronize()
    n7, n8 = rng.uniforms.launches, rcam.camera_rays.launches
    n11, n11m = dh.dense_hit.launches, dh.dense_hit.masked_launches
    n16, n17 = gr.gather_rows.launches, gr.gather_rows.backward_launches
    log(f"  the differentiable scan (method=\"scan\") at {R} rays, "
        f"depth {cfg.max_depth}, graphed: first call {first_s:.3f} s "
        f"(warm-up {cap['warmup_s']:.3f} s, capture {cap['capture_s']:.3f}"
        f" s, pool {cap['pool_bytes']} bytes, peak memory allocated "
        f"{capture_peak} bytes above the {base} before it); a replay: K7 "
        f"launches {n7}, K8 {n8}, K11 {n11} ({n11m} given the liveness "
        f"mask), K16 {n16}, K17 {n17}, {dg.SCAN_GRAPHS.replays} replays so "
        f"far; loss {float(loss):.9g}")
    # K17 once a trip but the last, whose rows reach no output.
    if not (n7 == n11 == n11m == n16 == trips and n8 == 1
            and n17 == trips - 1):
        raise AssertionError(f"the scan's K7, K8, K11, masked K11, K16 and "
                             f"K17 launches {n7}, {n8}, {n11}, {n11m}, "
                             f"{n16}, {n17} are not {trips}, 1, {trips}, "
                             f"{trips}, {trips}, {trips - 1}")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"the scan's gradient {k} is not finite")
    if not float(grads["albedo"].abs().max()) > 0.0:
        raise AssertionError("the scan's albedo gradient is zero")
    loss_e, grads_e = eager_scan()
    ulp = float(np.spacing(np.float32(abs(float(loss_e)))))
    dl = abs(float(loss) - float(loss_e))
    ratio = max(float(((g - grads_e[k]).abs()
                       / (1e-6 * grads_e[k].abs())).nan_to_num(0.0).max())
                for k, g in grads.items() if g.numel())
    log(f"  graph against the eager body: loss {float(loss):.9g} vs "
        f"{float(loss_e):.9g} (|a - b| {dl:.3g}, one ulp {ulp:.3g}); "
        f"gradients' largest |a - b| / (1e-6 |b|) {ratio:.4g} (bound 1)")
    if not (dl <= ulp and ratio <= 1.0):
        raise AssertionError("the graphed scan is off its eager body")
    # The five-argument route (K11 sweeps every ray, so a dead ray reads
    # the rows of whatever it finds, with a zero gradient): K17's sums are
    # the same bits.
    loss_f, grads_f = dg.scan_loss_and_grads(
        params, scene, cam, key, ids, target, None, cfg=cfg,
        intersect_fn=five_arguments)
    same = [k for k, g in grads_e.items()
            if not torch.equal(g, grads_f[k])]
    log(f"  the masked scan against the five-argument route, eager: loss "
        f"{float(loss_e):.9g} vs {float(loss_f):.9g}, every field "
        f"bit-equal {not same} (differing: {same})")
    if not (torch.equal(loss_e, loss_f) and not same):
        raise AssertionError("the masked scan is off the five-argument "
                             "route")
    del loss_e, grads_e, loss_f, grads_f
    kernels, device_ms = scan_profile(eager_scan, card)
    if any("indexing_backward" in name for _, _, name in kernels):
        raise AssertionError("torch's indexing backward runs in the scan")
    loss_r, grads_r = replay_step
    ratios = {k: float(((grads_r[k] - g).abs()
                        / (1e-7 + 2e-3 * g.abs())).max())
              for k, g in grads.items() if g.numel()}
    rl = abs(float(loss_r) - float(loss)) / abs(float(loss))
    log(f"  against the replay's step on the same rays: loss "
        f"{float(loss_r):.9g} vs the scan's {float(loss):.9g} (rel "
        f"{rl:.3e}, bound 1e-6); per field the largest |replay - scan| / "
        f"(1e-7 + 2e-3 |scan|) {ratios} (bound 1)")
    if not (rl <= 1e-6 and max(ratios.values()) <= 1.0):
        raise AssertionError("the scan is off the replay's step")
    times, peaks = scan_turns({"eager scan": eager_scan,
                               "graphed scan": graphed_scan}, card)
    return dict(launches=n7, k11=n11, k11_masked=n11m, k16=n16, k17=n17,
                rays=R, first_s=first_s, capture=cap,
                capture_peak=capture_peak, times=times, peaks=peaks,
                loss_ulps=dl / ulp, grad_ratio=ratio, replay_ratios=ratios,
                replay_loss_rel=rl, device_ms=device_ms, top=kernels[:8])


def five_arguments(scene, accel, origin, direction, t_min):
    """The dense closest hit without the liveness mask: every ray swept."""
    return default_intersect(scene, accel, origin, direction, t_min)


def scan_profile(body, card, top=8):
    """The card's kernels of one call of ``body`` under ``torch.profiler``,
    by device time: logs the ``top`` and returns them all ((ms, calls,
    name) each) and the total device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"  the eager scan under torch.profiler: {sum(r[1] for r in rows)} "
        f"device events, {total:.2f} ms of device time; on {card}")
    for t, n, name in rows[:top]:
        log(f"    {t:10.3f} ms {t / max(total, 1e-30) * 100:5.1f}% {n:7d}x "
            f"{name[:110]}")
    return rows, total


def rng_rays_path(dev, key, card, frame_draws, replay_step):
    """Phase 20.  ``frame_draws``: K7's and K8's launches over phase 12's
    frames, by mode; ``replay_step``: phase 18's (loss, grads) of the
    final scene's direct step at ``GRAD_RAYS`` rays.  Returns K7's and
    K8's entries of the kernels line."""
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    pack = ip.pack_scene_pallas(scene)
    key = key.to(dev)
    R = WAVE_RAYS
    ids = torch.arange(R, device=dev)
    depths = torch.randint(0, 51, (R,), generator=torch.Generator(
        ).manual_seed(0)).to(dev)
    last_ids, last_depth, last_alive, passes = last_pool_pass(
        scene, cam, cfg, key, pack)
    log(f"  the pool frame's last pass (pass {passes} of the frame op by "
        f"op): {int(last_alive.sum())} live slots, ids {int(last_ids.min())}"
        f"-{int(last_ids.max())}, depths {int(last_depth.min())}-"
        f"{int(last_depth.max())}")

    # The main path, the counters reset just before each run and read just
    # after: the pool recorder over 2^17 rays of the final scene through
    # K4, graphed, whose init makes its camera rays through K8 (its passes
    # draw and make rays inside K12 and K13, phase 22), and the replay of
    # its tape, which makes its rays through K8 and draws inside K14 and
    # K15 (phase 23).  K7's own path since then: the differentiable scan
    # (``method="scan"``), a draw a trip.
    def recorder(graphed_=None):
        return record_paths_pool(scene, cam, cfg, key, ids, pack,
                                 ip.intersect_pallas, pool_size=1 << 14,
                                 graphed=graphed_)
    reset_counts()
    tape = recorder()
    torch.cuda.synchronize()
    n7r, n8, c = rng.uniforms.launches, rcam.camera_rays.launches, \
        loop_counts()
    same = torch.equal(tape, recorder(False))
    log(f"  the pool recorder (2^14 slots) at {R} rays through K4, graphed:"
        f" K7 launches {n7r}, K8 launches {n8} ({c['warmups']} warm-up "
        f"block(s), {c['passes']} passes replayed, {c['replays']} "
        f"replays); its tape equal to the recorder op by op {same}")
    if not (n7r == 0 and n8 == 1 + c["warmups"]):
        raise AssertionError(f"the pool recorder's K7 and K8 launches {n7r}, "
                             f"{n8} are not none and one an init: {c}")
    if not same:
        raise AssertionError("the graphed pool recorder's tape differs")
    params, _ = dg.split_params(scene)
    target = torch.zeros((R, 3), device=dev)
    tape = tape[:rrep.live_trips(tape)]
    dg.render_loss_and_grads_tape(params, scene, cam, cfg, key, ids, target,
                                  tape)
    reset_counts()
    dg.render_loss_and_grads_tape(params, scene, cam, cfg, key, ids, target,
                                  tape)
    torch.cuda.synchronize()
    n7r, n8r = rng.uniforms.launches, rcam.camera_rays.launches
    n14, n15 = rreplay.replay.launches, rreplay.replay.backward_launches
    log(f"  the replay of its {tape.shape[0]} rows, graphed: K7 launches "
        f"{n7r}, K8 {n8r}, K14 {n14}, K15 {n15}")
    if not (n7r == 0 and n8r == 1 and n14 == n15 == 1):
        raise AssertionError(f"the replay's K7, K8, K14 and K15 launches "
                             f"{n7r}, {n8r}, {n14}, {n15} are not 0, 1, 1, 1")
    del tape
    scan = scan_path(params, scene, cam, cfg, key, ids[:GRAD_RAYS],
                     target[:GRAD_RAYS], replay_step, card)
    n7 = scan["launches"]
    dg.SCAN_GRAPHS.clear()

    # K7 and K8 against their plain versions on the card, bit for bit.
    draws = [("the camera draw at 2^17 ids", ids, 0, 0),
             ("the bounce draw at a 0-d depth 3", ids,
              torch.tensor(3, device=dev), 1),
             ("the bounce draws at per-ray depths 0-50, 2^17 ids", ids,
              depths, 1),
             ("the bounce draws of the pool frame's last pass", last_ids,
              last_depth, 1)]
    for label, i, dom, off in draws:
        before = rng.uniforms.launches
        got = rng.uniforms(key, i, dom, offset=off)
        torch.cuda.synchronize()
        if rng.uniforms.launches != before + 1:
            raise AssertionError("K7's launch counter did not move")
        bit_equal(f"K7 {label}", [got], [rng.uniforms_plain(key, i,
                                                            dom + off)])
    lens, lcam, lcfg = build_preset("camera-effects", device=dev)
    # K8 decodes ids below 2^32 in 32 bits and the rest through int64:
    # ids on both sides of 2^32 - 1; and the last chunk of a frame at the
    # default chunk, padded with its last id (render/api.py::render_rays).
    edge = torch.arange((1 << 32) - 4096, (1 << 32) + 4096, device=dev)
    chunk = DEFAULT_CHUNK
    tail = torch.arange(cfg.num_rays // chunk * chunk, cfg.num_rays,
                        device=dev)
    padded = torch.cat([tail, tail[-1:].expand(chunk - tail.shape[0])])
    rays = [("final scene, 2^17 ids", cam, cfg, ids),
            ("final scene, the pool frame's last pass", cam, cfg, last_ids),
            ("final scene, float64 camera, 2^17 ids", to_f64(cam), cfg,
             ids),
            (f"camera-effects (lens radius {float(lcam.lens_radius)}), "
             "2^17 ids", lcam, lcfg, ids),
            (f"final scene, ids {int(edge[0])}-{int(edge[-1])} around "
             "2^32 - 1", cam, cfg, edge),
            ("camera-effects, ids around 2^32 - 1", lcam, lcfg, edge),
            (f"final scene, the last chunk of {chunk} ({tail.shape[0]} ids "
             f"and {chunk - tail.shape[0]} of padding)", cam, cfg, padded)]
    for label, cm, cf, i in rays:
        before = rcam.camera_rays.launches
        got = rcam.camera_rays(cm, cf.nx, cf.ny, cf.spp, key, i)
        torch.cuda.synchronize()
        if rcam.camera_rays.launches != before + 1:
            raise AssertionError("K8's launch counter did not move")
        bit_equal(f"K8 {label}", got, rcam.camera_rays_plain(
            cm, cf.nx, cf.ny, cf.spp, key, i))
    del lens

    # Times at 32 to 2^17 rays, each call in a CUDA graph (20 calls a graph
    # for the kernels and for a one-element fill, a launch's floor; the
    # plain versions at 2^17, one call a graph, as they ran in the
    # wavefront graphs before, and one eager call).
    one = torch.empty(1, device=dev)
    sized = {}
    for n in RNG_RAYS_SIZES:
        i, dep = ids[:n], depths[:n].contiguous()
        floor = graph_ms(one.zero_, 7, 20)
        row = {"floor": floor}
        for name, fn, b in (
                ("K7", lambda: rng.uniforms(key, i, dep, offset=1),
                 k7_bound(n, True)),
                ("K7 camera draw", lambda: rng.camera_uniforms(key, i),
                 k7_bound(n)),
                ("K8", lambda: rcam.camera_rays(cam, cfg.nx, cfg.ny,
                                                cfg.spp, key, i),
                 k8_bound(n))):
            ms = graph_ms(fn, 7, 20)
            row[name] = ms
            log(f"  {name} at {n} rays: {ms:.5f} ms, {ms - floor:+.5f} "
                f"above the floor {floor:.5f} (bound {b[0]:.6f} ms by "
                f"{b[1]})")
        sized[n] = row
    ms7, cam_ms, ms8 = (sized[R][k] for k in ("K7", "K7 camera draw", "K8"))

    def plain7():
        return rng.uniforms_plain(key, ids, depths + 1)

    def plain8():
        return rcam.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    plain7_ms, plain8_ms = graph_ms(plain7, 5), graph_ms(plain8, 5)
    eager7_s, eager8_s = host_s(plain7)[0], host_s(plain8)[0]
    b7, b7c, b8 = k7_bound(R, True), k7_bound(R), k8_bound(R)
    log(f"  K7 at {R} bounce draws (per-ray depths): {ms7:.4f} ms (bound "
        f"{b7[0]:.5f} ms, {b7[1]}); the camera draw {cam_ms:.4f} ms (bound "
        f"{b7c[0]:.5f}, {b7c[1]}); plain {plain7_ms:.4f} ms in a graph, "
        f"{eager7_s * 1e3:.2f} ms eager")
    log(f"  K8 at {R} camera rays: {ms8:.4f} ms (bound {b8[0]:.5f} ms, "
        f"{b8[1]}); plain {plain8_ms:.4f} ms in a graph, "
        f"{eager8_s * 1e3:.2f} ms eager; on {card}")
    src = "first_raytracer_tpu_torch/kernels/csrc/rng_rays.cu"
    common = {"route": "cuda", "source": src, "max_abs_err": 0.0,
              "library_ms": None}
    return [dict(common, **{
        "name": "K7 Threefry draw (core.rng.uniforms), 2^17 bounce draws "
                "at per-ray depths",
        "replaces": rng.REPLACES, "launches": n7, "scan": scan,
        "frame_launches": {m: v[0] for m, v in frame_draws.items()},
        "ms": ms7, "plain_ms": plain7_ms, "plain_eager_ms": eager7_s * 1e3,
        "bound_ms": b7[0], "bound_by": b7[1], "camera_draw_ms": cam_ms,
        "camera_draw_bound_ms": b7c[0],
        "ms_by_rays": {n: {k: row[k] for k in ("floor", "K7",
                                               "K7 camera draw")}
                       for n, row in sized.items()}}), dict(common, **{
        "name": "K8 camera rays (render.camera.camera_rays), 2^17 rays of "
                "the final scene",
        "replaces": rcam.REPLACES, "launches": n8,
        "frame_launches": {m: v[1] for m, v in frame_draws.items()},
        "ms": ms8, "plain_ms": plain8_ms, "plain_eager_ms": eager8_s * 1e3,
        "bound_ms": b8[0], "bound_by": b8[1],
        "ms_by_rays": {n: {k: row[k] for k in ("floor", "K8")}
                       for n, row in sized.items()}})]


# Phase 21: the pool's slots and ray ids, and where its range starts; the
# stress set's pool (8192 blocks of K9, several waves) and ray ids.
PASS_POOL, PASS_RAYS, PASS_START = 1 << 17, 1 << 19, 1000
STRESS_POOL, STRESS_RAYS = 1 << 21, 1 << 22
# The graphed pass and trip before K9 and K10 (PERF.md section 5).
NODES_BEFORE = {"pool pass": 267, "trip": 259}
MAX_PASS_NODES = 4
# K17 a call on the card: the scratch's memset and one kernel (its
# earlier design took a memset and three kernels).
MAX_ROW_SUM_NODES = 2
# K9's and K10's readings before their redesign (PERF.md section 5, the
# proof run after review; an NVIDIA H100 80GB HBM3 at 700.00 W), printed
# beside this run's.
EARLIER_K9 = {
    "K9 pool": "0.0088 ms (bound 0.00404)",
    "K9 trip": "0.0064 ms (bound 0.00373)",
    "K10": "0.0081 ms with the cursor's copy, the copy alone 0.0015 "
           "(bound 0.00299)",
    "pool pass": "0.0780 ms, 5 nodes",
    "trip": "0.0679 ms, 4 nodes",
    "regenerative final scene": "0.0246, 0.0241 s/frame",
    "wavefront final scene": "0.3259, 0.3302 s/frame",
    "field20000 chunks": "0.1627, 0.1706 s/frame",
    "bvh pool frame": "0.0190, 0.0191 s/frame",
}
# The ``EARLIER`` entry of each earlier phase's frame that phase 21 lists.
FRAME_EARLIER = {"bvh pool frame": "bvh frame"}


def pass_sets(dev):
    """Phase 21's sets: (label, scene, camera, cfg, accel), the accel
    choosing the closest hit through ``default_intersect``."""
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    out = [("final scene through K4", scene, cam, cfg,
            ip.pack_scene_pallas(scene)),
           ("final scene through K6", scene, cam, cfg,
            build_bvh(scene, max_leaf=BVH_MAX_LEAF))]
    for label, preset, n, _ in FIELD_WAVE:
        fs, fc, fcfg = build_preset(preset, device=dev, n=n)
        out.append((f"{label} through K5", fs, fc, fcfg,
                    ic.pack_scene_clustered(fs)))
    ms, mc_, mcfg = build_preset("triangle-mesh", device=dev)
    out.append((f"triangle-mesh ({ms.num_spheres} spheres, "
                f"{ms.num_triangles} triangles), dense sweep", ms, mc_, mcfg,
                None))
    tris = dataclasses.replace(ms, sphere_center=ms.sphere_center[:0],
                               sphere_radius=ms.sphere_radius[:0],
                               sphere_mat=ms.sphere_mat[:0])
    out.append(("triangle-mesh's triangles alone, dense sweep", tris, mc_,
                mcfg, None))
    ls, lc, lcfg = build_preset("camera-effects", device=dev)
    out.append(("camera-effects (a checker, a lens), dense sweep", ls, lc,
                lcfg, None))
    return out


def k9_scan_words(what, got, want):
    """Fails unless K9's scan words (``got``) after a launch on them hold
    the ticket at a whole number of passes of tiles and every tile's word
    an inclusive prefix of that pass, nondecreasing by at most a tile, the
    last the plain record's survivors; then gives ``want`` K9's words,
    which the plain version does not write."""
    scan = got["scan"]
    blocks = scan.numel() - 1
    words = scan[1:]
    counts = words & 0xFFFFFFFF
    steps = torch.diff(counts, prepend=counts.new_zeros(1))
    passes = int(scan[0]) // blocks
    if not (int(scan[0]) == passes * blocks
            and bool((((words >> 32) & 3) == 2).all())
            and bool(((words >> 34) == passes - 1).all())
            and bool(((steps >= 0) & (steps <= wp.BLOCK)).all())
            and int(counts[-1]) == int(want["record"][0])):
        raise AssertionError(f"{what}: K9's scan words are not this pass's "
                             "inclusive prefixes")
    want["scan"] = scan


def same_state(what, got, want):
    """Fails unless every tensor of ``got`` equals its partner in
    ``want``; returns the largest difference (0.0 when equal)."""
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        diffs = {k: float((got[k].double() - want[k].double()).abs().max())
                 for k in bad}
        raise AssertionError(f"{what} differs from the plain version: "
                             f"{diffs}")
    return 0.0


def pool_vs_plain(label, scene, cam, cfg, key, accel, pool, num_rays):
    """K9 and K10 against ``shade_plain`` and ``regenerate_plain`` pass by
    pass over a pool of ``pool`` slots and ``num_rays`` ids from
    ``PASS_START``, each on a clone of the same state (K9's scan words
    carried over from pass to pass).  Returns the passes."""
    dev = scene.device
    start = torch.full((), PASS_START, dtype=torch.int64, device=dev)
    n = min(num_rays, cfg.num_rays - PASS_START)
    static = dict(cfg=cfg, num_rays=n, pool_size=pool)
    state = pool_state(scene, cam, key, start, **static)
    passes = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, accel, state["o"],
                                         state["d"], cfg.t_min)
        want = {k: v.clone() for k, v in state.items()}
        before = wp.shade.launches, wp.regenerate.launches
        wp.shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
                 start_id=start, num_rays=n)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
        k9_scan_words(f"{label}: pool pass {passes}", state, want)
        same_state(f"{label}: K9, pool pass {passes}", state, want)
        wp.regenerate(state, camera=cam, key=key, start_id=start, **static)
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
        same_state(f"{label}: K10, pool pass {passes}", state, want)
        if (wp.shade.launches, wp.regenerate.launches) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError("K9's or K10's counter did not move")
        passes += 1
        del want, prim, hit
    if int(state["cursor"]) != n:
        raise AssertionError(f"{label}: the pool did not spend its stream")
    return passes


def passes_vs_plain(label, scene, cam, cfg, key, accel):
    """``pool_vs_plain`` over a pool of ``PASS_POOL`` slots and
    ``PASS_RAYS`` ids, and K9 against ``shade_plain`` trip by trip over a
    chunk of ``WAVE_RAYS`` ids, each on a clone of the same state.
    Returns (passes, trips)."""
    dev = scene.device
    passes = pool_vs_plain(label, scene, cam, cfg, key, accel, PASS_POOL,
                           PASS_RAYS)
    ids = torch.arange(min(WAVE_RAYS, cfg.num_rays), device=dev)
    state = batch_state(scene, cam, key, ids, cfg=cfg)
    trips = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, accel, state["origin"],
                                         state["direction"], cfg.t_min)
        want = {k: v.clone() for k, v in state.items()}
        wp.shade(state, prim, hit, scene=scene, key=key, cfg=cfg)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg)
        same_state(f"{label}: K9, trip {trips}", state, want)
        state["depth"].add_(1)
        trips += 1
    return passes, trips


def counted_frame(what, frame, passes_k10):
    """``frame()`` with the counters reset just before and read just
    after: K9 once a pass or trip (as K4, K5 or K6), K10 once a pool pass
    (``passes_k10``) or not at all, K7 never, K8 only for the inits.
    Returns (image, launches)."""
    reset_counts()
    img = frame()
    torch.cuda.synchronize()
    c = loop_counts()
    n = {"K7": rng.uniforms.launches, "K8": rcam.camera_rays.launches,
         "K9": wp.shade.launches, "K10": wp.regenerate.launches}
    k = graphed.PASSES_PER_READ
    passes = c["passes"] + c["warmups"] * k
    log(f"  {what}, graphed: launches {n} ({c['warmups']} warm-up "
        f"block(s), {c['passes']} passes replayed, {c['replays']} replays)")
    if not (n["K9"] >= 1 and n["K9"] == passes and n["K7"] == 0
            and n["K10"] == (passes if passes_k10 else 0)):
        raise AssertionError(f"{what}: K9 and K10 not once a pass ({n}, "
                             f"{c})")
    if tuple(img.shape)[-1] != 3 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what}: bad image")
    return img, n


def wavefront_pass_path(dev, key, card, frames):
    """Phase 21.  ``frames``: the graphed frames' seconds of the earlier
    phases, by name.  Returns K9's and K10's entries of the kernels
    line."""
    key = key.to(dev)
    sets = pass_sets(dev)
    for label, scene, cam, cfg, accel in sets:
        t0 = time.perf_counter()
        passes, trips = passes_vs_plain(label, scene, cam, cfg, key, accel)
        log(f"  {label}: {passes} pool passes (K9 and K10) and {trips} "
            f"trips (K9) bit-equal to the plain versions "
            f"({time.perf_counter() - t0:.1f} s)")
    # The stress set: 8192 blocks of K9 a pass, several waves of them on
    # the card, so that look-backs wait on tiles still being shaded.
    label, scene, cam, cfg, pack = sets[0]
    t0 = time.perf_counter()
    passes = pool_vs_plain("stress", scene, cam, cfg, key, pack,
                           STRESS_POOL, STRESS_RAYS)
    log(f"  stress: a pool of {STRESS_POOL} slots "
        f"({STRESS_POOL // wp.BLOCK} blocks of K9) over {STRESS_RAYS} ids of "
        f"the final scene through K4: {passes} pool passes bit-equal to the "
        f"plain versions ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # The main path, the counters reset just before each frame and read
    # just after.
    golden = final_golden()
    launches = {}
    for mode in ("regenerative", "wavefront"):
        img, launches[mode] = counted_frame(
            f"the final scene's {mode} frame through K4",
            lambda: render_image(scene, cam, cfg, seed=0, accel=pack,
                                 mode=mode, chunk=WAVE_RAYS,
                                 pool_size=WAVE_RAYS, device=dev),
            mode == "regenerative")
        rel = abs(float(img.double().sum()) * cfg.spp - golden) / golden
        log(f"    radiance sum rel {rel:.2e} off the golden")
        if not rel < 1e-2:
            raise AssertionError(f"{mode}: radiance sum off golden ({rel})")
    if launches["regenerative"]["K8"] > 2:
        raise AssertionError("the pool frame made camera rays past its init")
    for (flabel, preset, n, gkey), (_, fs, fc, fcfg, cpack) in zip(
            FIELD_WAVE, sets[2:4]):
        img, launches[flabel] = counted_frame(
            f"{flabel} {fcfg.nx}x{fcfg.ny}@{fcfg.spp} chunks through K5",
            lambda: render_image(fs, fc, fcfg, seed=0, accel=cpack,
                                 chunk=WAVE_RAYS, device=dev), False)
        field_golden(f"{flabel} chunks through K9", flabel, gkey,
                     float(img.double().sum()) * fcfg.spp)

    # Times at 2^17 slots: the pool's state after its init and one pass
    # (K9 and K10 on live, dead and fresh slots), a chunk's first trip.
    R = WAVE_RAYS
    start = torch.zeros((), dtype=torch.int64, device=dev)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=R)
    inputs = dict(scene=scene, camera=cam, accel=pack, key=key,
                  start_id=start)
    state = pool_state(**inputs, **static)
    pool_pass(state, **inputs, intersect_fn=ip.intersect_pallas, **static)
    prim, _, hit = ip.intersect_pallas(scene, pack, state["o"], state["d"],
                                       cfg.t_min)
    shade_kw = dict(scene=scene, key=key, cfg=cfg, start_id=start,
                    num_rays=cfg.num_rays)
    # K9 compacts the pool in place: each call in the graph first restores
    # the pass's state, whose own time is taken off.
    work = {k: v.clone() for k, v in state.items()}

    def restore_pool():
        for k in wp.POOL_ROWS:
            work[k].copy_(state[k])

    def restored_k9():
        restore_pool()
        wp._launch_shade(work, prim, hit, **shade_kw)
    restore9_ms = graph_ms(restore_pool, 5, 20)
    ms9 = graph_ms(restored_k9, 5, 20) - restore9_ms
    # The plain version's ops do not depend on the data: its calls repeat
    # on one copy.
    plain = {k: v.clone() for k, v in state.items()}
    plain9 = graph_ms(lambda: wp.shade_plain(plain, prim, hit, **shade_kw),
                      5)
    plain = {k: v.clone() for k, v in state.items()}
    wp.shade_plain(plain, prim, hit, **shade_kw)
    live = int(state["alive"].sum())
    misses = int((state["alive"] & ~hit).sum())
    cont = int(plain["record"][0])
    b9 = k9_bound(scene, R, live, cont, misses)
    # K10 reads the pass record, not the cursor: its calls repeat one.
    restored_k9()
    ms10 = graph_ms(lambda: wp._launch_regenerate(
        work, camera=cam, key=key, start_id=start, **static), 5, 20)
    plain10 = graph_ms(lambda: wp.regenerate_plain(
        plain, camera=cam, key=key, start_id=start, **static), 5)
    b10 = k10_bound(R, cont)
    ids = torch.arange(R, device=dev)
    chunk = batch_state(scene, cam, key, ids, cfg=cfg)
    cprim, _, chit = ip.intersect_pallas(scene, pack, chunk["origin"],
                                         chunk["direction"], cfg.t_min)
    # K9 in trip mode changes its carry: each call in the graph first
    # restores the chunk's first trip, whose own time is taken off.
    tchunk = {k: v.clone() for k, v in chunk.items()}
    carry = ("origin", "direction", "throughput", "radiance", "alive",
             "segments")

    def restore():
        for k in carry:
            tchunk[k].copy_(chunk[k])

    def restored_k9t():
        restore()
        wp.shade(tchunk, cprim, chit, scene=scene, key=key, cfg=cfg)
    restore_ms = graph_ms(restore, 5, 20)
    ms9t = graph_ms(restored_k9t, 5, 20) - restore_ms
    after = {k: v.clone() for k, v in chunk.items()}
    wp.shade_plain(after, cprim, chit, scene=scene, key=key, cfg=cfg)
    plain9t = graph_ms(lambda: wp.shade_plain(
        {k: v.clone() for k, v in chunk.items()}, cprim, chit, scene=scene,
        key=key, cfg=cfg), 5)
    tlive = int(chunk["alive"].sum())
    tmisses = int((chunk["alive"] & ~chit).sum())
    tcont = int(after["alive"].sum())
    b9t = k9_bound(scene, R, tlive, tcont, tmisses, pool=False)
    log(f"  K9 at {R} pool slots ({live} live, {misses} missing, {cont} "
        f"going on): {ms9:.4f} ms, the pool's restore ({restore9_ms:.4f} "
        f"ms) taken off (bound {b9[0]:.5f} ms, {b9[1]}); plain "
        f"{plain9:.4f} ms in a graph; before the redesign "
        f"{EARLIER_K9['K9 pool']}")
    log(f"  K9 at {R} trip rays (a chunk's first trip: {tlive} live, "
        f"{tmisses} missing, {tcont} going on): {ms9t:.4f} ms, its carry's "
        f"restore ({restore_ms:.4f} ms) taken off (bound {b9t[0]:.5f} ms, "
        f"{b9t[1]}); plain {plain9t:.4f} ms in a graph; before the "
        f"redesign {EARLIER_K9['K9 trip']}")
    log(f"  K10 at {R} pool slots ({cont} survivors, {R - cont} tail "
        f"slots): {ms10:.4f} ms, the cursor written inside (bound "
        f"{b10[0]:.5f} ms, {b10[1]}); plain (the tail's camera rays over "
        f"every slot) {plain10:.4f} ms in a graph; before the redesign "
        f"{EARLIER_K9['K10']}; on {card}")

    # A graphed pool pass and trip at 2^17 slots: ms and nodes.
    def one_pass():
        pool_pass(state, **inputs, intersect_fn=ip.intersect_pallas,
                  **static)

    def one_trip():
        trip(chunk, scene=scene, accel=pack, key=key, cfg=cfg,
             intersect_fn=ip.intersect_pallas)
    pass_ms, trip_ms = graph_ms(one_pass, 5), graph_ms(one_trip, 5)
    nodes = {"pool pass": graph_nodes(one_pass), "trip": graph_nodes(one_trip)}
    k4_ms = graph_ms(lambda: ip.intersect_pallas(scene, pack, state["o"],
                                                 state["d"], cfg.t_min), 5)
    log(f"  a graphed pool pass at {R} slots: {pass_ms:.4f} ms, "
        f"{nodes['pool pass']} graph nodes (cuGraphGetNodes; before the "
        f"redesign {EARLIER_K9['pool pass']}; before K9 and K10 "
        f"{EARLIER['pool pass']}); a trip {trip_ms:.4f} ms, "
        f"{nodes['trip']} nodes (before the redesign {EARLIER_K9['trip']}; "
        f"before K9 and K10 {EARLIER['trip']}); K4 {k4_ms:.4f} ms alone; "
        f"on {card}")
    if max(nodes.values()) > MAX_PASS_NODES:
        raise AssertionError(f"a graphed pass has {nodes} nodes, more than "
                             f"{MAX_PASS_NODES}")
    for name, sec in frames.items():
        before = EARLIER[FRAME_EARLIER.get(name, name.split(" ")[0])]
        log(f"  {name}: {', '.join(f'{x:.4f}' for x in sec)} s/frame "
            f"graphed (earlier phases); before the redesign "
            f"{EARLIER_K9[name]}; before K9 and K10 {before}")
    src = "first_raytracer_tpu_torch/kernels/csrc/wavefront_pass.cu"
    common = {"route": "cuda", "source": src, "max_abs_err": 0.0,
              "library_ms": None}
    return [dict(common, **{
        "name": "K9 wavefront pass shading (render.wavefront_pass.shade), "
                "2^17 pool slots of the final scene",
        "replaces": wp.REPLACES_SHADE,
        "launches": launches["regenerative"]["K9"],
        "frame_launches": {m: v["K9"] for m, v in launches.items()},
        "ms": ms9, "plain_ms": plain9, "bound_ms": b9[0],
        "bound_by": b9[1], "trip_ms": ms9t, "trip_plain_ms": plain9t,
        "trip_bound_ms": b9t[0], "pool_pass_ms": pass_ms,
        "stress_passes": passes,
        "trip_pass_ms": trip_ms, "nodes": nodes, "nodes_before":
        NODES_BEFORE, "frame_s": frames}), dict(common, **{
        "name": "K10 pool regeneration (render.wavefront_pass.regenerate: "
                "the tail's camera rays and the cursor), 2^17 slots of the "
                "final scene",
        "replaces": wp.REPLACES_REGENERATE,
        "launches": launches["regenerative"]["K10"],
        "frame_launches": {m: v["K10"] for m, v in launches.items()},
        "ms": ms10, "plain_ms": plain10, "bound_ms": b10[0],
        "bound_by": b10[1]})]


# Phase 22: K11, K12 and K13, the recorders on the device.  The pool
# recorder's slots (the direct step's ``record_pool``), the rays of each set
# held pass by pass to the plain versions, and K11's rays on the fields.
RECORD_POOL = 1 << 14
RECORD_RAYS = 1 << 16
K11_FIELD_RAYS = 1 << 16
# K11's liveness masks: the live shares held to the plain version, and
# those timed.
K11_SHARES = (1.0, 0.5, 0.1, 0.03, 0.01, 0.001, 0.0)
K11_TIMED = (1.0, 0.1, 0.01)
# A graphed body's nodes before K11-K13, the closest hit included
# (``cuGraphGetNodes`` on the parent's bodies, probes/record_pass.py
# --turns, PERF.md section 5; an NVIDIA H100 80GB HBM3 at 700.00 W).
NODES_BEFORE_RECORD = {"lockstep bounce": 243, "pool pass": 283,
                       "length pass": 239}
# K12's live shares held to the plain seams and timed at the first bounce.
K12_SHARES = (1.0, 0.1, 0.01)
# Nodes of a graphed recorder body: the closest hit and K12 (the counter's
# add and K13 are K12's own now), against 3 each before (PERF.md section
# 5; an NVIDIA H100 80GB HBM3 at 700.00 W).
RECORD_BODY_NODES = 2
NODES_BEFORE_FOLD = 3
# K12's ms at the first bounce of 2^17 rays before it packed its live rays
# (PERF.md section 6; the same card), printed beside this run's.
EARLIER_K12_STEP = {("lockstep", 1.0): "0.0061 ms",
                    ("length", 1.0): "0.0063 ms"}
# The recorders' and the direct step's seconds before K11-K13 (PERF.md
# sections 5 and 6; an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside
# this run's.
EARLIER_K12 = {
    "direct step": "0.438-0.450 s (recorder 0.357-0.360, replay "
                   "0.082-0.090)",
    "recorder": "0.357-0.360 s",
    "pool recorder": "0.084-0.086 s",
    "field5000 direct step": "0.109-0.122 s",
}


def plain_lockstep(scene, o, d, ray_ids, key, cfg, length=False):
    """The lockstep recorder of the rays (o, d), or with ``length`` the
    occupancy scan's lengths, on the plain versions op by op
    (``intersect_brute``, ``record_step_plain``, which advances the
    counter, through ``render.graphed.run_eager``): any float type.
    Returns the tape with its scratch row, or the lengths."""
    def init():
        state = rrep.record_state(o, d, cfg=cfg, tape=not length)
        if length:
            state["length"] = torch.zeros(ray_ids.shape, dtype=torch.int64,
                                          device=o.device)
        return state

    def step(state):
        prim, _, hit = intersect_brute(scene, state["o"], state["dr"],
                                       cfg.t_min)
        rpass.record_step_plain(state, prim, hit, scene=scene, key=key,
                                ray_ids=ray_ids, cfg=cfg)
    state = graphed.run_eager(init, step, {}, {}, graphed.PASSES_PER_READ)
    return state["length" if length else "tape"]


def step_moved(state):
    """The keys of a lockstep or length state that K12 moves."""
    return [k for k in ("o", "dr", "alive", "d", "arrivals", "length")
            if k in state]


def direct_bounces(scene, cfg, key, o, d):
    """The lockstep recorder's bounces on the rays (o, d) as the direct
    step runs them, op by op: each bounce's (o, dr, alive, d) and the
    closest hit (prim, hit) K11 hands K12."""
    ids = torch.arange(o.shape[0], device=o.device)
    state = rrep.record_state(o, d, cfg=cfg)
    out = []
    while bool(state["alive"].any()):
        prim, _, hit = dh.dense_hit(scene, state["o"], state["dr"],
                                    cfg.t_min, state["alive"])
        out.append(({k: state[k].clone() for k in ("o", "dr", "alive",
                                                  "d")}, (prim, hit)))
        rrep.record_bounce(state, scene=scene, accel=None, key=key,
                           ray_ids=ids, cfg=cfg,
                           intersect_fn=default_intersect)
    return out


def plain_pool(scene, cam, key, ray_ids, cfg, pool):
    """The pool recorder of ``pool`` slots on the plain versions op by op
    (``intersect_brute``, ``record_shade_plain``,
    ``record_regenerate_plain``; the init's rays from
    ``camera_rays_plain``).  Returns the (max_depth + 1, R) tape."""
    def init():
        state = rrep.record_pool_state(cam, key, ray_ids, cfg=cfg,
                                       pool_size=pool)
        o, d = rcam.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key,
                                      state["ids"])
        state["o"].copy_(o)
        state["d"].copy_(d)
        return state

    def step(state):
        prim, _, hit = intersect_brute(scene, state["o"], state["d"],
                                       cfg.t_min)
        rpass.record_shade_plain(state, prim, hit, scene=scene, key=key,
                                 ray_ids=ray_ids, cfg=cfg)
        rpass.record_regenerate_plain(state, camera=cam, key=key,
                                      ray_ids=ray_ids, cfg=cfg)
    state = graphed.run_eager(init, step, {}, {}, graphed.PASSES_PER_READ)
    R, D = ray_ids.shape[0], cfg.max_depth + 1
    return state["tape"][:D * R].reshape(D, R)


def edge_scene(scene):
    """Two triangles sharing the diagonal from (-1, 0, -1) to (1, 0, 1) of
    a floor quad, each twice (ids 0-3), and no sphere; and 2^16 rays
    straight down onto the diagonal: exact ties in t."""
    dev = scene.device
    a, b = (-1.0, 0.0, -1.0), (1.0, 0.0, 1.0)
    tri = dataclasses.replace(
        scene, sphere_center=scene.sphere_center[:0],
        sphere_radius=scene.sphere_radius[:0],
        sphere_mat=scene.sphere_mat[:0],
        tri_v0=torch.tensor([a, a, a, a], device=dev),
        tri_v1=torch.tensor([(1.0, 0.0, -1.0), b] * 2, device=dev),
        tri_v2=torch.tensor([b, (-1.0, 0.0, 1.0)] * 2, device=dev),
        tri_mat=torch.zeros((4,), dtype=torch.int32, device=dev))
    s = torch.linspace(-0.99, 0.99, 1 << 16, device=dev)
    o = torch.stack([s, torch.ones_like(s), s], dim=1)
    d = torch.tensor([0.0, -1.0, 0.0], device=dev).expand(
        s.shape[0], 3).contiguous()
    return tri, o, d


def k11_sets(dev, key, scene, cam, cfg, o, d):
    """Phase 22's ray sets for K11: (label, scene, origin, direction)."""
    ids = torch.arange(o.shape[0], device=dev)
    state = rrep.record_state(o, d, cfg=cfg)
    prim, _, hit = intersect_brute(scene, o, d, cfg.t_min)
    rpass.record_step_plain(state, prim, hit, scene=scene, key=key,
                            ray_ids=ids, cfg=cfg)
    alive = state["alive"]
    out = [(f"final scene, {o.shape[0]} camera rays", scene, o, d),
           (f"final scene, one bounce's {int(alive.sum())} rays", scene,
            state["o"][alive].contiguous(), state["dr"][alive].contiguous())]
    for preset, n, label in (("sphere-field", 5000, "field5000"),
                             ("sphere-field", 20000, "field20000"),
                             ("triangle-field", 20000, "trifield20000")):
        fs, fc, fcfg = build_preset(preset, device=dev, n=n)
        fo, fd = camera_rays(fs, fc, fcfg, key, K11_FIELD_RAYS)
        out.append((f"{label}, {K11_FIELD_RAYS} camera rays", fs, fo, fd))
    twice = dataclasses.replace(
        scene, sphere_center=scene.sphere_center.repeat(2, 1),
        sphere_radius=scene.sphere_radius.repeat(2),
        sphere_mat=scene.sphere_mat.repeat(2))
    out.append(("final scene with every sphere twice (exact ties)", twice,
                o, d))
    out.append(("two triangles' shared edge, each twice (exact ties)",
                *edge_scene(scene)))
    return out


def live_mask(n, share, seed, dev):
    """A (n,) bool mask on ``dev``, each ray live with probability
    ``share`` (numpy's generator from ``seed``)."""
    return torch.from_numpy(
        np.random.default_rng(seed).random(n) < share).to(dev)


def k11_vs_plain(label, scene, o, d, shares=()):
    """K11 (``dense_hit`` on the card) against ``intersect_brute`` on the
    rays (o, d), prim, t and hit ``torch.equal``, the plain sweep in
    chunks of 2^27 (ray, primitive) pairs; then with a liveness mask of
    each of ``shares`` against ``dense_hit_plain`` (the same sweep, the
    miss where the mask is False) on every ray.  Returns the hits."""
    def k11(alive=None):
        before = dh.dense_hit.launches
        got = dh.dense_hit(scene, o, d, 1e-3, alive)
        torch.cuda.synchronize()
        if dh.dense_hit.launches != before + 1:
            raise AssertionError("K11's launch counter did not move")
        return got
    got = k11()
    step = max(1, (PLAIN_PAIRS // 2) // max(scene.num_primitives, 1))
    parts = [intersect_brute(scene, o[lo:lo + step], d[lo:lo + step], 1e-3)
             for lo in range(0, o.shape[0], step)]
    want = [torch.cat(p) for p in zip(*parts)]
    what = (f"K11, {label} ({scene.num_spheres} spheres, "
            f"{scene.num_triangles} triangles)")
    bit_equal(what, got, want, "intersect_brute")
    for k, share in enumerate(shares):
        alive = live_mask(o.shape[0], share, 1000 + k, o.device)
        prim, t, hit = want
        bit_equal(f"  {what}, {int(alive.sum())} live ({share})",
                  k11(alive), [torch.where(alive, prim, 0),
                               torch.where(alive, t, 1e30), hit & alive],
                  "dense_hit_plain")
    return int(got[2].sum())


def record_scan_words(what, got, want, passes):
    """Fails unless K12's pool-mode scan words (``got``) after ``passes``
    launches on them hold the ticket at ``passes`` times a pass's tickets
    (its tiles and one a block of its persistent grid, at most a tile's
    worth) and every tile's word an inclusive prefix of the last pass,
    nondecreasing by at most a tile, the last the plain record's
    survivors; then gives ``want`` K12's words, which the plain versions do
    not write."""
    scan = got["scan"]
    tiles = scan.numel() - 1
    words = scan[1:]
    counts = words & 0xFFFFFFFF
    steps = torch.diff(counts, prepend=counts.new_zeros(1))
    per_pass = int(scan[0]) // passes
    if not (int(scan[0]) == passes * per_pass
            and tiles < per_pass <= 2 * tiles
            and bool((((words >> 32) & 3) == 2).all())
            and bool(((words >> 34) == passes - 1).all())
            and bool(((steps >= 0) & (steps <= rpass.RECORD_TILE)).all())
            and int(counts[-1]) == int(want["record"][0])):
        raise AssertionError(f"{what}: K12's scan words are not this pass's "
                             "inclusive prefixes")
    want["scan"] = scan


def record_passes_vs_plain(label, scene, cam, cfg, key, accel):
    """K12 in lockstep and length modes bounce by bounce over
    ``RECORD_RAYS`` camera rays, and K12's pool launch (K13 folded in) pass
    by pass over a pool of ``RECORD_POOL`` slots and the same ids, each
    against its plain versions on a clone of the same state
    (``record_step_plain``, which advances the counter as K12 does;
    ``record_shade_plain`` then ``record_regenerate_plain``; K12's scan
    words checked and carried from pass to pass; the flat tape's last
    entry, which the plain pass scatters its non-writing lanes to, aside),
    through one inert bounce or pass past the last live one.  The closest
    hit is ``default_intersect`` on ``accel``.  Returns (bounces,
    passes)."""
    dev = scene.device
    n = min(RECORD_RAYS, cfg.num_rays)
    ids = torch.arange(n, device=dev)
    o, d = rcam.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    bounces = 0
    for mode in ("tape", "length"):
        state = rrep.record_state(o, d, cfg=cfg, tape=mode == "tape")
        if mode == "length":
            state["length"] = torch.zeros((n,), dtype=torch.int64,
                                          device=dev)
        b, live = 0, True
        while live:
            live = bool(state["alive"].any())
            prim, _, hit = default_intersect(scene, accel, state["o"],
                                             state["dr"], cfg.t_min)
            want = {k: v.clone() for k, v in state.items()}
            rpass.record_step(state, prim, hit, **kw)
            rpass.record_step_plain(want, prim, hit, **kw)
            same_state(f"{label}: K12 ({mode}), bounce {b}", state, want)
            if int(state["d"]) != b + 1:
                raise AssertionError(f"{label}: K12 ({mode}) left the "
                                     f"counter at {int(state['d'])} after "
                                     f"bounce {b}")
            b += 1
        bounces = max(bounces, b)
    state = rrep.record_pool_state(cam, key, ids, cfg=cfg,
                                   pool_size=RECORD_POOL)
    passes, live = 0, True
    while live:
        live = bool(state["alive"].any())
        prim, _, hit = default_intersect(scene, accel, state["o"],
                                         state["d"], cfg.t_min)
        want = {k: v.clone() for k, v in state.items()}
        before = (rpass.record_shade.launches,
                  rpass.record_shade.refill_launches)
        rpass.record_shade(state, prim, hit, camera=cam, **kw)
        rpass.record_shade_plain(want, prim, hit, **kw)
        rpass.record_regenerate_plain(want, camera=cam, **kw)
        record_scan_words(f"{label}: K12 (pool), pass {passes}", state, want,
                          passes + 1)
        want["tape"][-1] = state["tape"][-1]
        same_state(f"{label}: K12 (pool, K13 folded in), pass {passes}",
                   state, want)
        if (rpass.record_shade.launches,
                rpass.record_shade.refill_launches) != (before[0] + 1,
                                                        before[1] + 1):
            raise AssertionError("K12's pool launch did not count itself")
        passes += 1
    if int(state["cursor"]) != n:
        raise AssertionError(f"{label}: the pool did not spend its stream")
    return bounces, passes


def counted(what, fn, kernels):
    """``fn()`` with the counters reset just before and read just after;
    fails unless each of ``kernels`` (label: (wrapper, attribute)) was
    launched.  Returns (its seconds, its output, the launches)."""
    reset_counts()
    sec, out = host_s(fn)
    n = {k: getattr(f, a) for k, (f, a) in kernels.items()}
    c = loop_counts()
    log(f"  {what}, graphed: {sec:.4f} s, launches {n} ({c['warmups']} "
        f"warm-up block(s), {c['passes']} passes replayed, {c['replays']} "
        "replays)")
    if min(n.values()) < 1:
        raise AssertionError(f"{what}: a kernel of its path did not launch "
                             f"({n})")
    return sec, out, n


def restored_ms(restore, call):
    """Milliseconds of ``call`` with the state it changes restored before
    each call, 20 calls a CUDA graph, the restore's own time taken off."""
    def both():
        restore()
        call()
    return graph_ms(both, 5, 20) - graph_ms(restore, 5, 20)


def record_pass_path(dev, key, card):
    """Phase 22.  Returns the kernels line's entries of K11, K12 (its
    lockstep, length and pool modes) and K13."""
    key = key.to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    R, D = WAVE_RAYS, cfg.max_depth + 1
    ids = torch.arange(R, device=dev)
    o, d = camera_rays(scene, cam, cfg, key, R)

    # K11 against intersect_brute, bit for bit, without and with masks.
    for label, s, so, sd in k11_sets(dev, key, scene, cam, cfg, o, d):
        hits = k11_vs_plain(label, s, so, sd, K11_SHARES)
        log(f"    ({hits} of {so.shape[0]} rays hit)")
    bounce = rrep.record_state(o, d, cfg=cfg)
    prim, _, hit = dh.dense_hit(scene, o, d, cfg.t_min)
    rpass.record_step(bounce, prim, hit, scene=scene, key=key, ray_ids=ids,
                      cfg=cfg)
    bit_equal(f"K11, the first bounce's recorder state, its own mask "
              f"({int(bounce['alive'].sum())} live)",
              dh.dense_hit(scene, bounce["o"], bounce["dr"], cfg.t_min,
                           bounce["alive"]),
              dh.dense_hit_plain(scene, bounce["o"], bounce["dr"],
                                 cfg.t_min, bounce["alive"]),
              "dense_hit_plain")
    del bounce
    torch.cuda.empty_cache()

    # K12's modes and K13 against their plain versions on phase 21's sets.
    for label, s, c, cf, accel in pass_sets(dev):
        t0 = time.perf_counter()
        bounces, passes = record_passes_vs_plain(label, s, c, cf, key, accel)
        log(f"  {label}: {bounces} lockstep and length bounces (K12) and "
            f"{passes} pool passes (K12 with K13 folded in) bit-equal to the plain "
            f"versions ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # The main path, counters reset just before each run and read just
    # after: the direct step (the lockstep recorder), the pool recorder and
    # the occupancy scan; each output against the plain route op by op.
    params, _ = dg.split_params(scene)
    target = torch.zeros((R, 3), device=dev)
    po, pd = rcam.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    dg.render_loss_and_grads(params, scene, cam, cfg, key, ids, target)
    step_s, _, n_step = counted(
        "the direct step at 2^17 rays of the final scene",
        lambda: dg.render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                         target),
        {"K11": (dh.dense_hit, "launches"),
         "K12": (rpass.record_step, "launches")})
    if n_step["K11"] != n_step["K12"]:
        raise AssertionError(f"K11 and K12 not once a bounce: {n_step}")
    rec_s, tape, _ = counted(
        "the lockstep recorder (record_tape)",
        lambda: dg.record_tape(params, scene, cam, cfg, key, ids),
        {"K11": (dh.dense_hit, "launches"),
         "K12": (rpass.record_step, "launches")})
    bit_equal("  the direct step's tape (lockstep, graphed)", [tape],
              [plain_lockstep(scene, po, pd, ids, key, cfg)[:D]],
              "the plain route op by op")
    pool_s, pool, n_pool = counted(
        f"the pool recorder ({RECORD_POOL} slots)",
        lambda: dg.record_tape(params, scene, cam, cfg, key, ids,
                               record_pool=RECORD_POOL),
        {"K11": (dh.dense_hit, "launches"),
         "K12 pool": (rpass.record_shade, "launches"),
         "K13": (rpass.record_shade, "refill_launches")})
    if not n_pool["K11"] == n_pool["K12 pool"] == n_pool["K13"]:
        raise AssertionError(f"K11-K13 not once a pool pass: {n_pool}")
    bit_equal("  the pool recorder's tape (graphed)", [pool],
              [plain_pool(scene, cam, key, ids, cfg, RECORD_POOL)],
              "the plain route op by op")
    if not torch.equal(pool, tape):
        raise AssertionError("the pool recorder's tape differs from the "
                             "lockstep recorder's")
    occ_s, occ, n_len = counted(
        f"the occupancy scan ({R} rays)",
        lambda: wavefront_occupancy(scene, cam, cfg, seed=0, num_rays=R,
                                    device=dev),
        {"K11": (dh.dense_hit, "launches"),
         "K12 length": (rpass.record_step, "length_launches")})
    lengths = plain_lockstep(scene, po, pd, ids, key, cfg, length=True)
    ended = np.bincount(lengths.cpu().numpy(), minlength=D + 1)
    counts = (R - np.cumsum(ended)[:D]).tolist()
    alive = occ["alive_per_bounce"]
    log(f"  the occupancy scan's rays alive per bounce {alive[:8]}... equal "
        f"to the plain route's {counts == alive}")
    if counts != occ["alive_per_bounce"]:
        raise AssertionError("the occupancy counts differ from the plain "
                             "route's")

    # Times at 2^17, each call in a CUDA graph.  K11 on the camera rays,
    # without a mask and at live shares 1, 0.1 and 0.01.
    ms11 = graph_ms(lambda: dh.dense_hit(scene, o, d, cfg.t_min), 5, 20)
    plain11 = graph_ms(lambda: intersect_brute(scene, o, d, cfg.t_min), 3)
    b11 = k11_bound(scene, R)
    live11 = {}
    for share in K11_TIMED:
        alive = live_mask(R, share, 7, dev)
        live = int(alive.sum())
        live11[share] = dict(
            live=live, bound_ms=k11_bound(scene, R, live)[0],
            ms=graph_ms(lambda alive=alive: dh.dense_hit(
                scene, o, d, cfg.t_min, alive), 5, 20))
    prim, _, hit = dh.dense_hit(scene, o, d, cfg.t_min)
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    # K12, lockstep and length modes, at the first bounce of the camera
    # rays with masks of live shares 1, 0.1 and 0.01, each against the
    # plain seam; each call restores the rays, liveness and counter it
    # moves.
    step_ms, step_plain, step_bound = {}, {}, {}
    for mode in ("lockstep", "length"):
        for share in K12_SHARES:
            first = rrep.record_state(o, d, cfg=cfg, tape=mode == "lockstep")
            first["alive"].copy_(live_mask(R, share, 7, dev))
            if mode == "length":
                first["length"] = torch.zeros((R,), dtype=torch.int64,
                                              device=dev)
            work = {k: v.clone() for k, v in first.items()}
            after = {k: v.clone() for k, v in first.items()}
            rpass.record_step(work, prim, hit, **kw)
            rpass.record_step_plain(after, prim, hit, **kw)
            live = int(first["alive"].sum())
            same_state(f"K12 ({mode}) at the first bounce, {live} live",
                       work, after)
            key_ = (mode, share)
            step_bound[key_] = k12_bound(
                scene, R, live, int(after["alive"].sum()),
                int((first["alive"] & hit).sum()), mode)

            def restore(work=work, first=first):
                for k in step_moved(first):
                    work[k].copy_(first[k])
            step_ms[key_] = restored_ms(
                restore, lambda work=work: rpass.record_step(
                    work, prim, hit, **kw))
            step_plain[key_] = graph_ms(
                lambda after=after: rpass.record_step_plain(
                    after, prim, hit, **kw), 5)
            del work, after, first
    # K12 in lockstep mode summed over the direct step's bounces, each
    # bounce's state and K11's closest hit as the recorder hands them over.
    bounces = direct_bounces(scene, cfg, key, o, d)
    lock = rrep.record_state(o, d, cfg=cfg)
    sum_ms = sum_bound = 0.0
    for b, (p, h) in bounces:
        def restore(b=b):
            for k, v in b.items():
                lock[k].copy_(v)
        sum_ms += restored_ms(restore, lambda p=p, h=h: rpass.record_step(
            lock, p, h, **kw))
        live = int(b["alive"].sum()) if int(b["d"]) <= cfg.max_depth else 0
        plain = dict(rrep.record_state(o, d, cfg=cfg), **b)
        rpass.record_step_plain(plain, p, h, **kw)
        sum_bound += k12_bound(scene, R, live, int(plain["alive"].sum()),
                               int((b["alive"] & h).sum()), "lockstep")[0]
        del plain
    del lock
    # K12's pool launch (K13 folded in) after one pass, at the direct
    # step's 2^14 slots over its 2^17 ids and at 2^17 slots over 2^19.
    pool_ms = {}
    for slots, n_ids in ((RECORD_POOL, R), (R, 4 * R)):
        pids = torch.arange(n_ids, device=dev)
        pkw = dict(kw, ray_ids=pids)
        pstate = rrep.record_pool_state(cam, key, pids, cfg=cfg,
                                        pool_size=slots)
        rrep.record_pool_pass(pstate, camera=cam, accel=None, **pkw,
                              intersect_fn=default_intersect)
        pprim, _, phit = dh.dense_hit(scene, pstate["o"], pstate["d"],
                                      cfg.t_min, pstate["alive"])
        work = {k: v.clone() for k, v in pstate.items()}
        plain = {k: v.clone() for k, v in pstate.items()}
        rpass.record_shade(work, pprim, phit, camera=cam, **pkw)
        rpass.record_shade_plain(plain, pprim, phit, **pkw)
        rpass.record_regenerate_plain(plain, camera=cam, **pkw)
        plain["scan"], plain["tape"][-1] = work["scan"], work["tape"][-1]
        same_state(f"K12's pool launch at {slots} slots after a pass", work,
                   plain)

        def restore_pool(work=work, pstate=pstate):
            for k in rpass.RECORD_ROWS + ("cursor",):
                work[k].copy_(pstate[k])

        def both_plain(plain=plain, pprim=pprim, phit=phit, pkw=pkw):
            rpass.record_shade_plain(plain, pprim, phit, **pkw)
            rpass.record_regenerate_plain(plain, camera=cam, **pkw)
        live = int(pstate["alive"].sum())
        cont = int(plain["record"][0])
        pool_ms[slots] = dict(
            live=live, going_on=cont,
            ms=restored_ms(restore_pool, lambda work=work, pprim=pprim,
                           phit=phit, pkw=pkw: rpass.record_shade(
                               work, pprim, phit, camera=cam, **pkw)),
            plain_ms=graph_ms(both_plain, 5),
            bound=k12_bound(scene, slots, live, cont,
                            int((pstate["alive"] & phit).sum()), "pool",
                            tile=rpass.RECORD_TILE))
        del work, plain, pstate
    torch.cuda.empty_cache()
    log(f"  K11 at {R} camera rays: {ms11:.4f} ms (bound {b11[0]:.5f} ms, "
        f"{b11[1]}); plain {plain11:.4f} ms in a graph; with a mask: " +
        "; ".join(f"{v['live']} live ({k}) {v['ms']:.4f} ms (bound "
                  f"{v['bound_ms']:.5f})" for k, v in live11.items()))
    for (mode, share), ms in step_ms.items():
        bd = step_bound[(mode, share)]
        log(f"  K12 ({mode}) at the first bounce of {R} rays, {share} live: "
            f"{ms:.5f} ms, the restore taken off (bound {bd[0]:.5f} ms, "
            f"{bd[1]}; before {EARLIER_K12_STEP.get((mode, share), 'not '
            'measured')}); plain {step_plain[(mode, share)]:.4f} ms in a "
            "graph")
    log(f"  K12 (lockstep) summed over the direct step's {len(bounces)} "
        f"bounces: {sum_ms:.5f} ms (bound {sum_bound:.5f} ms)")
    for slots, v in pool_ms.items():
        log(f"  K12's pool launch (K13 folded in) at {slots} slots after a "
            f"pass ({v['live']} live, {v['going_on']} going on): "
            f"{v['ms']:.5f} ms, the pool's restore taken off (bound "
            f"{v['bound'][0]:.5f} ms, {v['bound'][1]}); plain "
            f"{v['plain_ms']:.4f} ms in a graph; on {card}")

    # A graphed recorder bounce, pool pass and length pass: ms and nodes.
    inputs = dict(scene=scene, accel=None, key=key, ray_ids=ids)
    static = dict(cfg=cfg, intersect_fn=default_intersect)
    lock = rrep.record_state(o, d, cfg=cfg)
    length = rrep.record_state(o, d, cfg=cfg, tape=False)
    length["length"] = torch.zeros((R,), dtype=torch.int64, device=dev)
    rpool = rrep.record_pool_state(cam, key, ids, cfg=cfg,
                                   pool_size=RECORD_POOL)
    bodies = {
        "lockstep bounce": lambda: rrep.record_bounce(lock, **inputs,
                                                      **static),
        "pool pass": lambda: rrep.record_pool_pass(rpool, camera=cam,
                                                   **inputs, **static),
        "length pass": lambda: metrics._length_pass(length, **inputs,
                                                    **static)}
    nodes = {k: graph_nodes(f) for k, f in bodies.items()}
    body_ms = {k: graph_ms(f, 5) for k, f in bodies.items()}
    log("  graphed bodies: " + "; ".join(
        f"{k} {body_ms[k]:.4f} ms, {nodes[k]} nodes (before K11-K13: "
        f"{NODES_BEFORE_RECORD[k]}; before K12 advanced the counter and "
        f"took K13 in: {NODES_BEFORE_FOLD})"
        for k in bodies) + f" (cuGraphGetNodes); on {card}")
    if max(nodes.values()) > RECORD_BODY_NODES:
        raise AssertionError(f"a graphed recorder body has {nodes} nodes, "
                             f"more than {RECORD_BODY_NODES}")

    # The direct step, the recorders and field5000's step, graphed, twice.
    fs, fc, fcfg = build_preset("sphere-field", device=dev, n=5000)
    fparams, _ = dg.split_params(fs)
    pack5 = ic.pack_scene_clustered(fs)
    dg.render_loss_and_grads(fparams, fs, fc, fcfg, key, ids, target, pack5)
    runs = {
        "direct step": lambda: dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target),
        "recorder": lambda: dg.record_tape(params, scene, cam, cfg, key,
                                           ids),
        "pool recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids, record_pool=RECORD_POOL),
        "field5000 direct step": lambda: dg.render_loss_and_grads(
            fparams, fs, fc, fcfg, key, ids, target, pack5)}
    times = {k: [host_s(f)[0] for _ in range(3)][1:] for k, f in runs.items()}
    log("  graphed, twice each after a warm call: " + "; ".join(
        f"{k} {', '.join(f'{t:.4f}' for t in v)} s (before K11-K13 "
        f"{EARLIER_K12[k]})" for k, v in times.items()) + f"; on {card}")

    # The final scene's frames without an accel: K11, with each pass's
    # mask.
    golden = final_golden()
    frames_s, frame_launches = {}, {}
    for mode in ("regenerative", "wavefront"):
        def frame(mode=mode):
            img = render_image(scene, cam, cfg, seed=0, accel=None,
                               mode=mode, chunk=WAVE_RAYS,
                               pool_size=WAVE_RAYS, device=dev)
            torch.cuda.synchronize()
            return img
        label = "pool" if mode == "regenerative" else "chunked"
        _, img, n = counted(f"the {label} frame without an accel", frame,
                            {"K11": (dh.dense_hit, "launches"),
                             "K9": (wp.shade, "launches")})
        c = loop_counts()
        if n["K11"] != n["K9"] or n["K11"] != c["passes"] + c["warmups"] \
                * graphed.PASSES_PER_READ:
            raise AssertionError(f"{label}: K11 not once a pass ({n}, {c})")
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image")
        total_rad = float(img.double().sum()) * cfg.spp
        rel = abs(total_rad - golden) / golden
        frames_s[label] = [host_s(frame)[0] for _ in range(2)]
        frame_launches[label] = n["K11"]
        log(f"  the {label} frame through K11: radiance sum {total_rad:.1f} "
            f"vs golden {golden:.1f} (rel {rel:.2e}); graphed "
            f"{', '.join(f'{t:.4f}' for t in frames_s[label])} s; on {card}")
        if not rel < 1e-2:
            raise AssertionError(f"{label}: radiance sum off golden ({rel})")

    src = "first_raytracer_tpu_torch/kernels/csrc/"
    common = {"route": "cuda", "max_abs_err": 0.0, "library_ms": None}
    k12 = dict(common, source=src + "wavefront_pass.cu", nodes=nodes,
               nodes_before=NODES_BEFORE_RECORD, body_ms=body_ms)

    def shares(mode):
        return {str(share): {
            "ms": step_ms[(mode, share)],
            "plain_ms": step_plain[(mode, share)],
            "bound_ms": step_bound[(mode, share)][0]}
            for share in K12_SHARES}
    small, big = pool_ms[RECORD_POOL], pool_ms[R]
    fused = dict(k12, **{
        "replaces": rpass.REPLACES_POOL, "ms": small["ms"],
        "plain_ms": small["plain_ms"], "bound_ms": small["bound"][0],
        "bound_by": small["bound"][1], "pool_recorder_s": pool_s,
        "slots_2p17": {"ms": big["ms"], "plain_ms": big["plain_ms"],
                       "bound_ms": big["bound"][0]}})
    first = (K12_SHARES[0],)
    return [dict(common, **{
        "name": "K11 dense closest hit (kernels.dense_hit), 2^17 camera "
                "rays of the final scene",
        "source": src + "dense_hit.cu", "replaces": dh.REPLACES,
        "launches": n_step["K11"],
        "pool_recorder_launches": n_pool["K11"],
        "occupancy_launches": n_len["K11"],
        "frame_launches": frame_launches, "frames_s": frames_s,
        "ms": ms11, "masked": {str(k): v for k, v in live11.items()},
        "plain_ms": plain11, "bound_ms": b11[0], "bound_by": b11[1]}),
        dict(k12, **{
            "name": "K12 recorder pass, lockstep mode "
                    "(diff.record_pass.record_step), the first bounce of "
                    "2^17 rays of the final scene, every ray live",
            "replaces": rpass.REPLACES_STEP, "launches": n_step["K12"],
            "ms": step_ms[("lockstep", *first)],
            "plain_ms": step_plain[("lockstep", *first)],
            "bound_ms": step_bound[("lockstep", *first)][0],
            "bound_by": step_bound[("lockstep", *first)][1],
            "live_shares": shares("lockstep"),
            "direct_step_bounces": {"bounces": len(bounces), "ms": sum_ms,
                                    "bound_ms": sum_bound},
            "step_s": step_s, "recorder_s": rec_s, "times_s": times}),
        dict(k12, **{
            "name": "K12 recorder pass, length mode (record_step in "
                    "utils.metrics._length_pass), the first bounce of "
                    "2^17 rays, every ray live",
            "replaces": rpass.REPLACES_LENGTH,
            "launches": n_len["K12 length"],
            "ms": step_ms[("length", *first)],
            "plain_ms": step_plain[("length", *first)],
            "bound_ms": step_bound[("length", *first)][0],
            "bound_by": step_bound[("length", *first)][1],
            "live_shares": shares("length"), "occupancy_s": occ_s}),
        dict(fused, **{
            "name": "K12 recorder pass, pool mode, with K13's refill "
                    "(diff.record_pass.record_shade), 2^14 slots of the "
                    "final scene after a pass",
            "launches": n_pool["K12 pool"]}),
        dict(fused, **{
            "name": "K13 pool recorder regeneration, folded into K12's "
                    "pool launch: that launch's numbers",
            "launches": n_pool["K13"]})]


# Phase 23: K14 and K15, the tape replay on the device.  K15's float64
# gradients against the plain loop's autograd, relative L2 per field: the
# CPU tests' bound (tests/test_torch_replay_pass.py).
REPLAY_F64_BOUND = 1e-8
# The replay, the steps and K14 and K15 in their first design (PERF.md
# section 5; an NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's.
EARLIER_REPLAY = {"nodes": "58", "graphed replay": "0.0010-0.0024 s",
                  "direct step": "0.0040-0.0069 s",
                  "bucketed step": "0.043-0.116 s",
                  "K14": "0.0845-0.0961 ms", "K15": "0.3984-0.4123 ms"}
# The graphs of the bodies on the plain loop, kept apart from ``dg.GRAPHS``.
PLAIN_GRAPHS = dg.GraphCache(maxsize=4)


@contextlib.contextmanager
def plain_replay():
    """The plain loop in place of K14 and K15 in ``trace_rays_replay``,
    the bodies' graphs in ``PLAIN_GRAPHS``: the card's yardstick."""
    saved = rrep.replay, dg.GRAPHS
    rrep.replay, dg.GRAPHS = rreplay.replay_plain, PLAIN_GRAPHS
    try:
        yield
    finally:
        rrep.replay, dg.GRAPHS = saved


def replay_sets(dev, key):
    """Phase 23's sets: (label, scene, camera, cfg, o, d, tape) of 2^17
    camera rays, the final scene on K2b's tape and on JAX's golden tape,
    field5000 on K3t's."""
    R = GRAD_RAYS
    ids = torch.arange(R, device=dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    o, d = rcam.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    tape_b = rm.record_paths_mega(mk.pack_scene_mega(scene), cam, cfg, key,
                                  num_rays=R)
    with np.load(GRAD_GOLDEN_TAPE) as saved:
        jax_tape = torch.from_numpy(saved["tape"].astype(np.int32)).to(dev)
    f5, cam5, cfg5 = build_preset("sphere-field", device=dev, n=5000)
    o5, d5 = rcam.camera_rays(cam5, cfg5.nx, cfg5.ny, cfg5.spp, key, ids)
    tape5 = rm.record_paths_mega_clustered(
        mc.pack_scene_mega_clustered(f5, cam5), cam5, cfg5, key, num_rays=R)
    return ids, [("final scene, K2b's tape", scene, cam, cfg, o, d, tape_b),
                 ("final scene, JAX's tape", scene, cam, cfg, o, d,
                  jax_tape),
                 ("field5000, K3t's tape", f5, cam5, cfg5, o5, d5, tape5)]


def replay_loss(fn, scene, o, d, ids, key, cfg, tape):
    """The mean squared radiance (a zero target) of the replay ``fn`` as a
    function of the params."""
    return lambda p: torch.mean(fn(dg.merge_params(scene, p), o, d, ids,
                                   key, cfg, tape) ** 2)


def replay_vs_plain(label, scene, cfg, o, d, ids, key, tape):
    """K14's float32 radiance ``torch.equal`` to the plain loop's; K15's
    float64 gradients within ``REPLAY_F64_BOUND`` of the plain loop's
    autograd, its float32 ones logged beside.  Returns the largest float64
    |a - b| and relative error."""
    with torch.no_grad():
        got = rreplay.replay_kernels(scene, o, d, ids, key, cfg, tape)
        want = rreplay.replay_plain(scene, o, d, ids, key, cfg, tape)
    bit_equal(f"K14 float32 radiance, {label}", [got], [want])
    worst = {}
    for dtype in ("float32", "float64"):
        sc = scene if dtype == "float32" else to_f64(scene)
        o_, d_ = (o, d) if dtype == "float32" else (o.double(), d.double())
        params, _ = dg.split_params(sc)
        loss_k, gk = dg.value_and_grad(replay_loss(
            rreplay.replay_kernels, sc, o_, d_, ids, key, cfg, tape), params)
        loss_p, gp = dg.value_and_grad(replay_loss(
            rreplay.replay_plain, sc, o_, d_, ids, key, cfg, tape), params)
        errs = {k: rel_err(gk[k], gp[k]) for k in gp}
        abs_err = max(float((gk[k].double() - gp[k].double()).abs().max())
                      if gp[k].numel() else 0.0 for k in gp)
        log(f"    K15 {dtype} gradients, {label}: loss {float(loss_k):.17g} "
            f"vs plain {float(loss_p):.17g}; relative L2 error by field "
            + ", ".join(f"{k} {e[0]:.3e}" if e[0] is not None else
                        f"{k} (zero; port norm {e[1]:.3e})"
                        for k, e in errs.items())
            + f"; largest |a - b| {abs_err:.3e}"
            + (f" (bound {REPLAY_F64_BOUND:g})" if dtype == "float64"
               else " (logged)"))
        if dtype == "float64":
            bad = [k for k, (e, n) in errs.items()
                   if (n != 0.0 if e is None else not e <= REPLAY_F64_BOUND)]
            dl = abs(float(loss_k) - float(loss_p)) / float(loss_p)
            if bad or not dl <= REPLAY_F64_BOUND:
                raise AssertionError(f"K15's float64 gradients off the plain "
                                     f"loop's on {label}: {bad}")
            worst = dict(abs=abs_err, rel=max(
                (e for e, _ in errs.values() if e is not None), default=0.0))
    return worst


def replay_turns(fns, plain_fns, card):
    """Seconds of each step through K14 and K15 and through the plain
    loop's graph, in turns (kernels, plain, plain, kernels, kernels,
    plain) after a warm call of each; logs and returns the medians."""
    times = {k: {"kernels": [], "plain": []} for k in fns}
    for k in fns:
        fns[k]()
        with plain_replay():
            plain_fns[k]()
        for route in ("kernels", "plain", "plain", "kernels", "kernels",
                      "plain"):
            if route == "kernels":
                times[k][route].append(host_s(fns[k])[0])
            else:
                with plain_replay():
                    times[k][route].append(host_s(plain_fns[k])[0])
    log("  graphed, in turns (kernels, plain, plain, kernels, kernels, "
        "plain), s: " + "; ".join(
            f"{k}: K14/K15 {', '.join(f'{t:.4f}' for t in v['kernels'])}, "
            f"plain loop {', '.join(f'{t:.4f}' for t in v['plain'])} "
            f"(before: {EARLIER_REPLAY[k]})" for k, v in times.items())
        + f"; on {card}")
    return {k: {r: statistics.median(t) for r, t in v.items()}
            for k, v in times.items()}


def replay_pass_path(dev, key, card):
    """Phase 23.  Returns K14's and K15's entries of the kernels line."""
    R = GRAD_RAYS
    key = key.to(dev)
    ids, sets = replay_sets(dev, key)
    worst = {"abs": 0.0, "rel": 0.0}
    for label, sc, _, cf, o, d, tape in sets:
        w = replay_vs_plain(label, sc, cf, o, d, ids, key, tape)
        worst = {k: max(worst[k], w[k]) for k in worst}
    label, scene, cam, cfg, o, d, tape = sets[0]
    del sets
    torch.cuda.empty_cache()
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)

    # The main path, the counters reset just before each run and read just
    # after: the direct step (the whole tape's value and gradient, one K14
    # and one K15 a replay of its graph) and the bucketed step (one each a
    # bucket).
    dg.render_loss_and_grads(params, scene, cam, cfg, key, ids, target)
    reset_counts()
    loss, grads = dg.render_loss_and_grads(params, scene, cam, cfg, key,
                                           ids, target)
    torch.cuda.synchronize()
    n14, n15 = rreplay.replay.launches, rreplay.replay.backward_launches
    record = dg.tape_recorder(scene, cam, cfg, ids, dev)
    plan = plan_buckets(record(scene, key))

    def bucketed():
        tape_ = record(scene, key)
        return dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape_,
            plan=plan_buckets(tape_))
    bucketed()
    reset_counts()
    bucketed()
    torch.cuda.synchronize()
    m14, m15 = rreplay.replay.launches, rreplay.replay.backward_launches
    log(f"  the main path, counters reset: the direct step at {R} rays: K14 "
        f"{n14}, K15 {n15} (loss {float(loss):.9g}); the bucketed step "
        f"({len(plan[1])} buckets {plan[1]}): K14 {m14}, K15 {m15}")
    if not (n14 == n15 == 1 and m14 == m15 == len(plan[1])):
        raise AssertionError("the steps did not launch K14 and K15 once a "
                             "replay of each bucket")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient {k}")

    # K14 and K15 alone at 2^17 rays on K2b's tape (each call in a CUDA
    # graph, its replays timed by events, median of 5), and the plain
    # loop's forward and backward eager (median of 3).
    sph, tri = (t if t is None else t.detach()
                for t in rreplay._payload_tables(scene))
    k = rng.device_key(key, dev)
    fwd_args = (sph, tri, o, d, ids, k, tape, cfg.max_depth, cfg.t_min)
    rad, save, end, hist = rreplay.launch_forward(*fwd_args)
    g_rad = 2.0 * rad / rad.numel()

    def k14():
        return rreplay.launch_forward(*fwd_args)

    def k15():
        return rreplay.launch_backward(sph, tri, ids, k, tape, cfg.max_depth,
                                       cfg.t_min, save, end, hist, g_rad)
    ms14, ms15 = graph_ms(k14, 5), graph_ms(k15, 5)
    ms14_nograd = graph_ms(lambda: rreplay.launch_forward(
        *fwd_args, grads=False), 5)
    fwd_s, bwd_s = [], []
    for _ in range(3):
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in params.items()}
        with torch.enable_grad():
            t_f, out = host_s(lambda: torch.mean(rreplay.replay_plain(
                dg.merge_params(scene, leaves), o, d, ids, key, cfg,
                tape) ** 2))
            t_b, _ = host_s(lambda: torch.autograd.grad(
                out, list(leaves.values()), allow_unused=True))
        fwd_s.append(t_f)
        bwd_s.append(t_b)
    plain_fwd_ms = statistics.median(fwd_s) * 1e3
    plain_bwd_ms = statistics.median(bwd_s) * 1e3

    # Bounds from this run's rays: the rows each visited and shaded, the
    # rays that added radiance and the bounces K15 swept back.
    contributing = int((end >= 0).sum())
    swept = int(end.clamp(min=0).long().sum())
    lead = (tape >= 0).int().cumprod(0).sum(0).long()
    visits = int(torch.where(end >= 0, end.long() + 1, lead).sum())
    shaded = int(torch.where(end >= 0, end.long(), lead).sum())
    values = sum(t.numel() for t in (sph, tri) if t is not None)
    b14 = k14_bound(values, R, visits, shaded)
    b15 = k15_bound(values, R, contributing, swept)
    scratch = rreplay.scratch_bytes(tape.shape[0], R)
    # The deepest rays' rows (K14 walks a ray cut at the cap to the end of
    # the tape; K15 sweeps from a miss), the deep rays that take a K15 warp
    # each, and the grids (the blocks the card holds at once).
    walked = int(torch.where(end >= 0, end.long() + 1, lead).max())
    deepest = int(end.max())
    deep = int((end >= rreplay.DEEP_ROWS).sum())
    grids = {k: rreplay.resident_blocks(k == "K15", torch.float32)
             for k in ("K14", "K15")}
    log(f"  K14 at {R} rays, {tape.shape[0]} rows: {ms14:.4f} ms with the "
        f"scratch ({scratch / 1e6:.1f} MB, {visits} rows visited, {shaded} "
        f"shaded, the deepest ray {walked} rows), {ms14_nograd:.4f} ms "
        f"without (bound {b14[0]:.5f} ms, {b14[1]}; before: "
        f"{EARLIER_REPLAY['K14']}); K15 {ms15:.4f} ms ({contributing} rays "
        f"add radiance, {swept} bounces swept back, the deepest from row "
        f"{deepest}, {deep} rays of {rreplay.DEEP_ROWS} rows or more a warp "
        f"each; bound {b15[0]:.5f} ms, {b15[1]}; before: "
        f"{EARLIER_REPLAY['K15']}); resident blocks {grids}; the plain loop "
        f"eager: forward {plain_fwd_ms:.1f} ms, backward {plain_bwd_ms:.1f} "
        f"ms (median of 3); on {card}")

    # The replay's graph, and the steps graphed through the kernels in
    # turns with the same bodies graphed on the plain loop.
    def replay_body():
        return dg.tape_loss_and_grads(params, scene, cam, key, ids, target,
                                      tape, cfg=cfg)
    nodes = graph_nodes(replay_body)
    with plain_replay():
        plain_nodes = graph_nodes(replay_body)
    log(f"  the whole-tape replay's graph ({tape.shape[0]} rows): {nodes} "
        f"nodes through K14 and K15, {plain_nodes} on the plain loop "
        f"(before: {EARLIER_REPLAY['nodes']})")

    def step_fns():
        return {
            "graphed replay": lambda: dg.render_loss_and_grads_tape(
                params, scene, cam, cfg, key, ids, target, tape),
            "direct step": lambda: dg.render_loss_and_grads(
                params, scene, cam, cfg, key, ids, target),
            "bucketed step": bucketed}
    turns = replay_turns(step_fns(), step_fns(), card)
    src = "first_raytracer_tpu_torch/kernels/csrc/replay.cu"
    common = {"route": "cuda", "source": src, "replaces": rreplay.REPLACES,
              "library_ms": None, "nodes": nodes, "plain_nodes": plain_nodes,
              "steps_s": turns}
    return [dict(common, **{
        "name": "K14 tape replay forward (diff.replay_pass.replay), 2^17 "
                "rays of the final scene on K2b's tape, with the scratch",
        "launches": n14, "bucketed_launches": m14, "max_abs_err": 0.0,
        "ms": ms14, "ms_without_scratch": ms14_nograd,
        "plain_ms": plain_fwd_ms, "bound_ms": b14[0], "bound_by": b14[1],
        "scratch_bytes": scratch, "deepest_rows": walked,
        "resident_blocks": grids["K14"]}), dict(common, **{
        "name": "K15 tape replay backward (diff.replay_pass.replay), 2^17 "
                "rays of the final scene on K2b's tape",
        "launches": n15, "bucketed_launches": m15,
        "max_abs_err": worst["abs"], "max_rel_err_f64": worst["rel"],
        "ms": ms15, "plain_ms": plain_bwd_ms, "bound_ms": b15[0],
        "bound_by": b15[1], "deepest_rows": deepest, "deep_rays": deep,
        "resident_blocks": grids["K15"]})]


def recorded_trips(params, scene, cam, cfg, key, ids):
    """One eager scan (zero target) with ``integrator.gather_rows``
    wrapped: each trip's tables, indices and, from hooks on its rows, the
    gradients that its K17 launch sums, for the trips whose rows reach the
    loss (all but the last)."""
    trips = []
    real = tint.gather_rows

    def recording(table, idx):
        out = real(table, idx)
        entry = [tuple(t.detach() for t in table), tuple(idx),
                 [None] * len(out)]
        trips.append(entry)
        for k, o in enumerate(out):
            if o.requires_grad:
                o.register_hook(
                    lambda g, k=k, e=entry: e[2].__setitem__(k, g))
        return out
    tint.gather_rows = recording
    try:
        dg.scan_loss_and_grads(params, scene, cam, key, ids,
                               torch.zeros((ids.shape[0], 3),
                                           device=ids.device),
                               None, cfg=cfg, intersect_fn=default_intersect)
    finally:
        tint.gather_rows = real
    return [(t, i, g) for t, i, g in trips if None not in g]


def rows_vs_plain(label, trips, card):
    """K16 ``torch.equal`` to ``index_select`` and K17 bit-equal to its
    plain version (torch ops on the card) and the same bits over 3
    launches, on every trip of ``trips``; K17 within its bound of a float64
    sum (``index_add_`` into float64): ``row_sum_bound``, plus that sum's
    own error (n_row 2^-52 times the sum of magnitudes), plus two units in
    the last place of the table's type.  Returns the largest |K17 - f64|
    over that bound."""
    worst = 0.0
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for tables, idxs, grads in trips:
        rows = gr.launch_gather(tables, idxs)
        if not all(torch.equal(a, t.index_select(0, i))
                   for a, t, i in zip(rows, tables, idxs)):
            raise AssertionError(f"{label}: K16 differs from index_select")
        shapes = [tuple(t.shape) for t in tables]
        sums = [gr.launch_row_sum(grads, idxs, shapes) for _ in range(3)]
        for k, (g, i, sh) in enumerate(zip(grads, idxs, shapes)):
            plain = gr.row_sum_plain(g, i, sh[0])
            b = bits[plain.dtype]
            if not all(torch.equal(x[k].view(b), plain.view(b))
                       for x in sums):
                raise AssertionError(f"{label}: K17 differs from its plain "
                                     "version or between launches")
            f64 = torch.zeros(sh, dtype=torch.float64, device=g.device)
            f64.index_add_(0, i, g.double())
            mags = torch.zeros_like(f64).index_add_(0, i, g.double().abs())
            count = torch.bincount(i, minlength=sh[0]).double()[:, None]
            ref = f64.to(g.dtype).abs()
            ulp = (torch.nextafter(ref, torch.full_like(ref, float("inf")))
                   - ref).double()
            bound = (gr.row_sum_bound(g, i, sh[0]) + count * 2.0 ** -52
                     * mags + 2 * ulp)
            worst = max(worst, float(((sums[0][k].double() - f64).abs()
                                      / bound.clamp_min(1e-300)).max()))
    log(f"  {label}: {len(trips)} trips, K16 torch.equal to index_select, "
        f"K17 bit-equal to its plain version and over 3 launches; K17 "
        f"against the float64 sum: largest |a - b| / bound {worst:.4g} "
        f"(bound 1)")
    if worst > 1.0:
        raise AssertionError(f"{label}: K17 is off the float64 sum")
    return worst


def rows_times(tables, idxs, grads, card):
    """K16 and K17 at one trip's tables, indices and gradients, each call
    in a CUDA graph (20 a graph, median of 5), beside their plain versions
    and the library calls: ``index_select`` for K16; for K17 torch's
    indexing backward (``index_put_`` accumulating, what autograd runs for
    ``table[idx]``) and ``index_add_`` into float64, each table once."""
    shapes = [tuple(t.shape) for t in tables]
    zeros = [torch.zeros(sh, dtype=t.dtype, device=t.device)
             for sh, t in zip(shapes, tables)]
    zeros64 = [z.double() for z in zeros]

    def indexing_backward():
        for z, g, i in zip(zeros, grads, idxs):
            z.zero_().index_put_((i,), g, accumulate=True)

    def index_add_f64():
        for z, g, i in zip(zeros64, grads, idxs):
            z.zero_().index_add_(0, i, g.double())
    ms = {"K16": graph_ms(lambda: gr.launch_gather(tables, idxs), 5, 20),
          "K16 plain (index_select)": graph_ms(
              lambda: gr.gather_plain(tables, idxs), 5, 20),
          "K17": graph_ms(lambda: gr.launch_row_sum(grads, idxs, shapes),
                          5, 20),
          "K17 plain": graph_ms(lambda: [
              gr.row_sum_plain(g, i, sh[0])
              for g, i, sh in zip(grads, idxs, shapes)], 5),
          "indexing backward": graph_ms(indexing_backward, 5),
          "index_add_ float64": graph_ms(index_add_f64, 5, 20)}
    R = idxs[0].shape[0]
    bound = gather_rows_bound(shapes, R, tables[0].element_size())
    live = int((grads[0] != 0).any(1).sum())
    log(f"  one trip, {R} rays, tables {shapes} ({live} rays with a "
        f"nonzero gradient on the first): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; bound {bound[0]:.5f} ms ({bound[1]}); on {card}")
    return ms, bound


def rows_paths(trip, card):
    """K17's path and resident blocks on ``trip`` (the final scene's first,
    float32), its and K16's graph nodes a call (K17 at most
    ``MAX_ROW_SUM_NODES``: the memset and one kernel), and K17's global
    path on the same trip, its material table padded with rows no ray
    reads past the shared budget: bit-equal to its plain version and over 3
    launches, and timed.  Returns them, with ``worst`` (``rows_vs_plain``)
    and ``timed`` (``rows_times``) of the global path."""
    tables, idxs, grads = trip
    shapes = [tuple(t.shape) for t in tables]
    lib, _ = mk.load_mega_library()

    def path(shapes):
        entries = sum(r * c for r, c in shapes)
        return {"path": "shared" if lib.frt_row_sum_shared(entries)
                else "global",
                "resident blocks": lib.frt_row_sum_resident(entries, 0)}
    info = dict(path(shapes), **{
        "K17 nodes a call": graph_nodes(
            lambda: gr.launch_row_sum(grads, idxs, shapes)),
        "K16 nodes a call": graph_nodes(
            lambda: gr.launch_gather(tables, idxs))})
    last, pad = tables[-1], tables[-1].shape[0]
    while path(shapes[:-1] + [(last.shape[0] + pad, last.shape[1])]
               )["path"] == "shared":
        pad *= 2
    big = tables[:-1] + (torch.cat([last, last.new_zeros((pad,
                                                          last.shape[1]))]),)
    big_shapes = [tuple(t.shape) for t in big]
    info["global path"] = dict(path(big_shapes), **{
        "tables": big_shapes,
        "K17 nodes a call": graph_nodes(
            lambda: gr.launch_row_sum(grads, idxs, big_shapes))})
    log(f"  K17's path on the final scene's tables {shapes}: {info['path']}"
        f", {info['resident blocks']} resident blocks; graph nodes a call: "
        f"K17 {info['K17 nodes a call']}, K16 {info['K16 nodes a call']}; "
        f"the global path, the material table padded to {big_shapes[-1]}: "
        f"{info['global path']}")
    if info["path"] != "shared" or info["global path"]["path"] != "global":
        raise AssertionError(f"K17's paths: {info}")
    if max(info["K17 nodes a call"], info["global path"]["K17 nodes a call"]
           ) > MAX_ROW_SUM_NODES or info["K16 nodes a call"] != 1:
        raise AssertionError(f"K16's or K17's graph nodes: {info}")
    info["worst"] = rows_vs_plain("the final scene's first trip, K17's "
                                  "global path", [(big, idxs, grads)], card)
    info["timed"] = rows_times(big, idxs, grads, card)
    return info


def gather_rows_path(dev, key, card, scan):
    """Phase 24.  ``scan``: phase 20's readings of the differentiable
    scan (its K16 and K17 launches a replay).  Returns K16's and K17's
    entries of the kernels line."""
    key = key.to(dev)
    ids = torch.arange(GRAD_RAYS, device=dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    params, _ = dg.split_params(scene)
    trips = recorded_trips(params, scene, cam, cfg, key, ids)
    hot = trips[0][1][0]
    log(f"  the final scene's scan at {GRAD_RAYS} rays: {len(trips)} trips "
        f"with a gradient; the first trip's hottest sphere row read by "
        f"{int(torch.bincount(hot).max())} rays")
    worst = rows_vs_plain("the final scene (spheres, materials), float32",
                          trips, card)
    f64 = [(tuple(t.double() for t in ts), i, tuple(g.double() for g in gs))
           for ts, i, gs in trips[::5]]
    worst = max(worst, rows_vs_plain("the final scene, float64 (every 5th "
                                     "trip)", f64, card))
    timed = {"float32 trip 0": rows_times(*trips[0], card),
             "float32 trip 1": rows_times(*trips[1], card),
             "float64 trip 0": rows_times(*f64[0], card)}
    trips0 = trips[0]
    del f64, trips
    tm, tcam, tcfg = build_preset("triangle-mesh", device=dev)
    tparams, _ = dg.split_params(tm)
    ttrips = recorded_trips(tparams, tm, tcam, tcfg, key, ids)
    worst = max(worst, rows_vs_plain(
        "triangle-mesh (spheres, triangles, materials), float32", ttrips,
        card))
    timed["triangle-mesh trip 0"] = rows_times(*ttrips[0], card)
    del ttrips
    info = rows_paths(trips0, card)
    worst = max(worst, info.pop("worst"))
    timed["float32 trip 0, the global path"] = info.pop("timed")
    del trips0
    torch.cuda.empty_cache()
    ms, bound = timed["float32 trip 0"]
    src = "first_raytracer_tpu_torch/kernels/csrc/gather_rows.cu"
    by_set = {k: {n: v for n, v in m.items()} | {"bound_ms": b[0]}
              for k, (m, b) in timed.items()}
    common = {"route": "cuda", "source": src, "bound_ms": bound[0],
              "bound_by": bound[1], "by_set": by_set, "paths": info}
    return [dict(common, **{
        "name": "K16 row gather (kernels.gather_rows), the first trip of "
                "the final scene's scan at 2^17 rays",
        "replaces": gr.REPLACES, "launches": scan["k16"],
        "max_abs_err": 0.0, "ms": ms["K16"],
        "plain_ms": ms["K16 plain (index_select)"],
        "library_ms": ms["K16 plain (index_select)"]}), dict(common, **{
        "name": "K17 deterministic row sum (kernels.gather_rows backward), "
                "the first trip of the final scene's scan at 2^17 rays",
        "replaces": gr.REPLACES_BACKWARD, "launches": scan["k17"],
        "max_abs_err": 0.0, "f64_err_over_bound": worst, "ms": ms["K17"],
        "plain_ms": ms["K17 plain"],
        "library_ms": ms["indexing backward"],
        "index_add_f64_ms": ms["index_add_ float64"]})]


def bench_runs(card):
    """Phase 17: ``python3 bench_torch.py`` in subprocesses, one for each
    of ``BENCH_RUNS``.  Each must exit 0 with one JSON line without an
    ``error`` whose ``launches`` show its kernel.  Returns each kernel's
    launches by label (and K7's to K10's where a run launched them)."""
    launches = {}
    for label, switches, kernel in BENCH_RUNS:
        env = dict(os.environ, **switches)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if lines else {}
        if proc.returncode != 0 or "error" in line or len(lines) != 1:
            log(proc.stderr[-4000:])
            raise AssertionError(f"bench_torch.py {label} exited "
                                 f"{proc.returncode}: {proc.stdout[-2000:]}")
        n = line["launches"][kernel]
        if n < 1:
            raise AssertionError(f"bench_torch.py {label} launched no "
                                 f"{kernel}: {line['launches']}")
        launches.setdefault(kernel, {})[label] = n
        for draw in ("K7", "K8", "K9", "K10"):  # the wavefront modes'
            if line["launches"].get(draw):
                launches.setdefault(draw, {})[label] = \
                    line["launches"][draw]
        seen = READINGS.get(label)
        log(f"  {label}: {line['value']:.4f} Mpaths/s, {line['mrays_s']:.3f}"
            f" Mrays/s, {line['seconds']:.4f} s median, vs_baseline "
            f"{line['vs_baseline']:.3f}, {kernel} launches {n} "
            f"({wall:.1f} s of process); the earlier phase's "
            + (f"{seen:.4f} Mpaths/s (packs and plan inside its time)"
               if seen is not None else "reading: none")
            + f"; on {line['device']}")
    return launches


STARTED = 0.0  # main's start, on the host's clock


def phase_done(n):
    """Logs the seconds since the script started, after phase ``n``."""
    log(f"[phase {n} done at {time.perf_counter() - STARTED:.1f} s]")


def main():
    global STARTED
    STARTED = time.perf_counter()
    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(card)

    build()  # 2.
    phase_done(2)
    key = rng.base_key(0)
    k1, scene, cam, cfg, pack, final_img, k1_steps, k1_segs = render_path(
        dev, key, card)  # 3, 4.
    phase_done(4)
    log("K2 and K2b vs plain:")
    k2_launches = tape_kernels_vs_plain(dev, key, card, scene, cam, cfg,
                                        pack, k1_segs)  # 5.
    phase_done(5)
    del k1_segs
    g = grad_path(dev, key, card, scene, cam, cfg, pack)  # 6.
    phase_done(6)
    fit_cli(card)  # 7.
    phase_done(7)
    del scene, pack
    torch.cuda.empty_cache()
    log("K3 vs plain:")
    clustered_vs_plain(dev, key, card)  # 8.
    phase_done(8)
    k3_launches, fields, scenes = large_scene_path(dev, key, card)  # 9.
    phase_done(9)
    log("K3t and the clustered fit step:")
    t10 = clustered_tapes_and_step(dev, key, card, scenes)  # 10.
    phase_done(10)
    del scenes
    torch.cuda.empty_cache()
    log("K4 and K5 vs plain:")
    err4, err5 = intersect_vs_plain(dev, key)  # 11.
    phase_done(11)
    k4 = dense_wavefront_path(dev, key, card)  # 12.
    phase_done(12)
    k5, err4_fields = clustered_wavefront_path(dev, key, card)  # 13.
    phase_done(13)
    k4["max_abs_err"] = max(err4, err4_fields)
    k5["max_abs_err"] = max(err5, k5["max_abs_err"])
    torch.cuda.empty_cache()
    log("The sharded megakernels in one process (NCCL, world size 1):")
    f20_img = fields["field20000"]["img"]
    slice14 = sharded_one_process(dev, key, card, final_img, f20_img)  # 14.
    phase_done(14)
    torch.cuda.empty_cache()
    log("Two processes on the one card (parallel.dryrun, gloo):")
    slice15 = two_processes(dev, card, final_img, f20_img, g["step"])  # 15.
    phase_done(15)
    log("cli occupancy:")
    occupancy_cli(dev, key, card, *k1_steps)  # 16.
    phase_done(16)
    log("bench_torch.py:")
    bench = bench_runs(card)  # 17.
    phase_done(17)
    torch.cuda.empty_cache()
    log("The direct gradient step:")
    direct = direct_step_path(dev, key, card)  # 18.
    phase_done(18)
    torch.cuda.empty_cache()
    log("K6, the flat-BVH walk:")
    k6 = bvh_walk_path(dev, key, card, direct.pop("tape"))  # 19.
    phase_done(19)
    torch.cuda.empty_cache()
    log("K7 and K8, the Threefry draw and the camera rays:")
    k7, k8 = rng_rays_path(dev, key, card, k4["draw_launches"],
                           direct.pop("step"))  # 20.
    phase_done(20)
    k7["bench_launches"] = bench.get("K7", {})
    k8["bench_launches"] = bench.get("K8", {})
    torch.cuda.empty_cache()
    log("K9 and K10, the wavefront pass's shading and regeneration:")
    frames = {f"{m} final scene": k4["frame_s"][m]["graphed"]
              for m in k4["frame_s"]}
    frames["field20000 chunks"] = k5["frame_s"]["graphed"]
    frames["bvh pool frame"] = k6["frame_s"]["K6"]
    k9, k10 = wavefront_pass_path(dev, key, card, frames)  # 21.
    phase_done(21)
    k9["bench_launches"] = bench.get("K9", {})
    k10["bench_launches"] = bench.get("K10", {})
    torch.cuda.empty_cache()
    log("K11, K12 and K13, the recorders on the device:")
    k11_13 = record_pass_path(dev, key, card)  # 22.
    phase_done(22)
    torch.cuda.empty_cache()
    log("K14 and K15, the tape replay on the device:")
    k14_15 = replay_pass_path(dev, key, card)  # 23.
    phase_done(23)
    torch.cuda.empty_cache()
    log("K16 and K17, the scan's row gathers and their sums:")
    k16_17 = gather_rows_path(dev, key, card, k7["scan"])  # 24.
    phase_done(24)
    k6["bench_launches"] = bench["K6"]
    k4["direct_step_launches"] = direct["launches"]["K4"]
    k5["direct_step_launches"] = direct["launches"]["K5"]
    k1["sharded_launches"] = {"phase14": slice14["K1"]}
    k4["sharded_launches"] = {"phase15": slice15["K4"]}
    k1["bench_launches"] = bench["K1"]
    k4["bench_launches"] = bench["K4"]
    k5["bench_launches"] = bench["K5"]

    src = "first_raytracer_tpu_torch/kernels/csrc/"
    f20 = fields["field20000"]
    log(json.dumps({"kernels": [k1, {
        "name": "K2 megakernel with tape (render_pixels_mega "
                "emit_tape=True)",
        "route": "cuda", "source": src + "megakernel.cu",
        "replaces": mk.REPLACES, "launches": k2_launches,
        "max_abs_err": g["err2"], "tape_agreement": g["agree2"],
        "ms": g["k2_ms"],
        "plain_ms": g["plain2_ms"], "bound_ms": g["k2_bound"][0],
        "bound_by": g["k2_bound"][1], "library_ms": None}, {
        "name": "K2b standalone recorder (record_paths_mega)",
        "route": "cuda", "source": src + "megakernel.cu",
        "replaces": rm.REPLACES, "launches": g["launches"]["K2b"],
        "max_abs_err": g["err_b"], "tape_agreement": g["agree_b"],
        "ms": g["kb_ms"],
        "plain_ms": g["plain_b_ms"], "bound_ms": g["kb_bound"][0],
        "bound_by": g["kb_bound"][1], "library_ms": None,
        "sharded_launches": {"phase15": slice15["K2b"]},
        "bench_launches": bench["K2b"]}, {
        "name": "K3 clustered megakernel (render_pixels_mega_clustered), "
                "field20000 800x450@4 (plain_ms: a quarter of the pixels)",
        "route": "cuda", "source": src + "megakernel_clustered.cu",
        "replaces": mc.REPLACES, "launches": k3_launches,
        "max_abs_err": f20["err"], "ms": f20["ms"],
        "plain_ms": f20["plain_ms"],
        "bound_ms": f20["bound"][0], "bound_by": f20["bound"][1],
        "library_ms": None, "sharded_launches": {"phase14": slice14["K3"]},
        "bench_launches": bench["K3"]},
        {
        "name": "K3t clustered recorder (record_paths_mega_clustered), "
                "2^17 rays of field5000",
        "route": "cuda", "source": src + "megakernel_clustered.cu",
        "replaces": mc.REPLACES, "launches": t10["launches"],
        "max_abs_err": t10["trips_err"], "tape_agreement": t10["agree"],
        "tape_agreement_with_k2b": t10["agree_k2b"], "ms": t10["ms"],
        "plain_ms": t10["plain_ms"], "bound_ms": t10["bound"][0],
        "bound_by": t10["bound"][1], "library_ms": None,
        "bench_launches": bench["K3t"]}, k4, k5, k6, k7, k8, k9, k10,
        *k11_13, *k14_15, *k16_17]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
