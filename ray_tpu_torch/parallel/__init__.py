"""ray_tpu_torch.parallel: the mixture-of-experts layer on one card
(``moe``: ``top_k_routing``, ``moe_ffn``). Meshes, shardings,
collectives, sequence parallelism and expert parallelism across cards are
not ported yet (ROADMAP.md Queue 1, ``parallel/``). Like ``ops``, the
package re-exports nothing: callers import ``parallel.moe``, whose module
globals a profiler or a test may wrap."""
