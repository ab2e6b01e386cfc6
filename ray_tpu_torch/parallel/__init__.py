"""ray_tpu_torch.parallel: the device mesh (``mesh``), logical-axis
sharding rules (``sharding``), collectives over named mesh axes
(``collectives``), ring and Ulysses sequence-parallel attention
(``ring_attention``), the mixture-of-experts layer with expert parallelism
over ``ep`` (``moe``), the GPipe schedule over ``pp`` (``pipeline``), and
the multi-device dry run (``dryrun``). Like ``ops``, the package re-exports
nothing: callers import ``parallel.mesh``, ``parallel.collectives`` and so
on, whose module globals a profiler or a test may wrap."""
