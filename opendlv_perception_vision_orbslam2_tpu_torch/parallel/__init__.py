"""Multi-device SLAM over ``torch.distributed``: the edge-sharded global BA
and the observation-sharded pose solve.

Counterpart of the reference package's ``parallel/`` (``shard_map`` +
``psum`` over a device mesh).  Two layers:

  collectives    the all-reduce and broadcast every sharded solve goes
                 through, with counters (calls, host seconds)
  sharded_ba     the SPMD primitives of the global BA: each rank passes its
  sharded_pose   own block of edges or observations, every reduction is one
                 ``all_reduce_sum`` on the caller's group (rank order),
                 and every rank gets the same bits back
  serve          the engine hookup: rank 0 runs the one ``StereoSlam`` /
                 ``MonocularSlam``, ranks 1..D-1 run ``serve``, which takes
                 each op rank 0 posts and joins its reductions
  launch         the CLI's ranks: one a visible card (NCCL), spawned by
                 rank 0, the caller's process, and torn down with it

Why one engine and workers, not one engine a rank as every JAX process runs
the same program: the engine adopts its asynchronous stages (mapping, loop
verdicts, keyframe decisions) when a CUDA event has completed, which two
processes reach at different frames, and its scatter-adds outside the GBA
add float atomics in arrival order.  Replicas would drift apart, make
different numbers of collective calls, and hang the group.  The reference
package's production path is the same shape: one process owns every device,
the engine runs once, and only the edge reductions spread over the mesh.

The CLI forms the group itself (``launch.LocalRanks``: gloo on the CPU or
with several ranks on one card, NCCL one rank a card); other callers may
form the default group themselves and call ``serve`` on ranks 1..D-1.  Only
local cards: nothing here forms a group across hosts, as the reference CLI
takes only its host's devices.
"""
