"""ray_tpu_torch.parallel: the device mesh (``mesh``), logical-axis
sharding rules (``sharding``), collectives over named mesh axes
(``collectives``), ring and Ulysses sequence-parallel attention
(``ring_attention``), and the mixture-of-experts layer on one card
(``moe``). Expert and pipeline parallelism across cards are not ported yet
(ROADMAP.md Queue 1 item 2). Like ``ops``, the package re-exports nothing:
callers import ``parallel.mesh``, ``parallel.collectives`` and so on, whose
module globals a profiler or a test may wrap."""
