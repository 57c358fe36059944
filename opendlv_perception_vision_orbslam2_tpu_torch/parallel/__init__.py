"""Multi-device SLAM over ``torch.distributed``: the edge-sharded global BA
and the observation-sharded pose solve.

Counterpart of the reference package's ``parallel/`` (``shard_map`` +
``psum`` over a device mesh).  Two layers:

  collectives    the all-reduce and broadcast every sharded solve goes
                 through, with counters (calls, host seconds)
  sharded_ba     the SPMD primitives of the global BA: each rank passes its
  sharded_pose   own block of edges or observations, every reduction is one
                 ``all_reduce(SUM)`` on the caller's group, and every rank
                 gets the same bits back
  serve          the engine hookup: rank 0 runs the one ``StereoSlam`` /
                 ``MonocularSlam``, ranks 1..D-1 run ``serve``, which takes
                 each op rank 0 broadcasts and joins its reductions

Why one engine and workers, not one engine a rank as every JAX process runs
the same program: the engine adopts its asynchronous stages (mapping, loop
verdicts, keyframe decisions) when a CUDA event has completed, which two
processes reach at different frames, and its scatter-adds outside the GBA
add float atomics in arrival order.  Replicas would drift apart, make
different numbers of collective calls, and hang the group.  The reference
package's production path is the same shape: one process owns every device,
the engine runs once, and only the edge reductions spread over the mesh.

The process group is the caller's: the package never calls
``init_process_group``.  Tested with gloo (on the CPU, and with several ranks
on one card); NCCL, one rank a card, is untested.
"""
