"""Runtime sanitizers of the port (the KVSAN part of repro.analysis).

  * ``repro_torch.analysis.kvsan`` — KVSAN, an opt-in runtime sanitizer
    (``PagedPipelineBatcher(kvsan=True)`` / ``launch.serve --kvsan``)
    shadowing every KV page's lifecycle (alloc -> write -> COW-alias ->
    spill -> promote -> migrate -> free) in a pure-Python model; serving
    under KVSAN is token-identical, leaks surface as
    ``ServeStats.kvsan_leaks``.

The reference's static lint pass and kernel/oracle registry are tooling
that the port does not carry yet (ROADMAP.md, queue 1, tooling).
"""
