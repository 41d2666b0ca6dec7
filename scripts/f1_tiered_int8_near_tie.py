#!/usr/bin/env python
"""Where the int8 tiered serve of tests/test_torch_cluster.py parts from
the cold one (ROADMAP F1): the reference's weights are seeded by the
per-process ``hash(name)``, so the case depends on PYTHONHASHSEED.

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/f1_tiered_int8_near_tie.py \\
      [--seed 42] [--case cluster-fetch-int8]

Runs on the CPU with both packages, as the tests do (it re-executes itself
under the given PYTHONHASHSEED). It serves the three prompt families cold
on int8 pages and tiered (the test's case) through the JAX package and
the port, checks that the two packages give the same tokens, and for the
first request whose tiered tokens part from the cold ones prints the
step, both choices, and their logits in the fp32 model (no quantized
pages) run over the prompt and the tokens both serves share: a near tie
when the margin is small beside the logits.
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", default="42")
    ap.add_argument("--case", default="cluster-fetch-int8",
                    choices=["cluster-fetch-int8", "host-tier-int8"])
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != args.seed:
        env = dict(os.environ, PYTHONHASHSEED=args.seed)
        sys.exit(subprocess.run([sys.executable] + sys.argv, env=env).returncode)

    import jax
    import numpy as np
    import torch

    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serving import cluster_kv as jck
    from repro.serving import continuous as jcont
    from repro.serving import loop as jloop
    from repro.serving import request as jreq
    from repro.serving.pipeline import AsymmetricPipeline as JPipe
    from repro_torch import bridge
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import model as PM
    from repro_torch.serving import cluster_kv as pck
    from repro_torch.serving import continuous as pcont
    from repro_torch.serving import loop as ploop
    from repro_torch.serving import request as preq
    from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe

    cfg = get_config("granite-8b").reduced()
    pcfg = port_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    pparams = bridge.params_from_numpy(tree, device="cpu")
    dev = jax.devices()[0]
    split = [1, cfg.num_layers - 1]

    def families(req):
        reqs = []
        for i in range(6):
            rng = np.random.RandomState(100 + i % 3)
            prompt = rng.randint(0, cfg.vocab_size, size=24).astype(np.int32)
            reqs.append(req.Request(rid=i, prompt=prompt, max_new_tokens=4,
                                    arrival=0.3 * i))
        return reqs

    kw = (dict(prefix_caching=True, kv_dtype="int8")
          if args.case == "cluster-fetch-int8" else
          dict(stage_blocks=[10, 10], prefix_caching=True, host_blocks=64,
               host_swap_cost=0.05, kv_dtype="int8"))
    n_rep = 2 if args.case == "cluster-fetch-int8" else 1
    tiered = {}
    for name, cont, ck, loop, req, pipe in (
            ("jax", jcont, jck, jloop, jreq,
             lambda: JPipe(cfg, jparams, split, [[dev]] * len(split))),
            ("port", pcont, pck, ploop, preq,
             lambda: PPipe(pcfg, pparams, split, device="cpu"))):
        reqs = families(req)
        ws = [cont.PagedPipelineBatcher(pipe(), replica_id=i, n_slots=2,
                                        max_len=48, block_size=8, **kw)
              for i in range(n_rep)]
        if n_rep > 1:
            ck.wire_cluster_prefix(ws)
        loop.run_serve_loop(ws, reqs, deadline=1e9,
                            clock=loop.VirtualClock())
        tiered[name] = [list(map(int, r.output)) for r in reqs]
    reqs = families(preq)
    pcont.PagedPipelineBatcher(PPipe(pcfg, pparams, split, device="cpu"),
                               n_slots=2, max_len=48, block_size=8,
                               kv_dtype="int8").serve(reqs, deadline=1e9)
    cold = [list(map(int, r.output)) for r in reqs]
    print(f"PYTHONHASHSEED={args.seed} case {args.case}: port tiered == "
          f"JAX tiered: {tiered['port'] == tiered['jax']}; tiered == cold: "
          f"{tiered['port'] == cold}")
    for rid, (t, c) in enumerate(zip(tiered["port"], cold)):
        if t == c:
            continue
        j = next(i for i, (a, b) in enumerate(zip(t, c)) if a != b)
        seq = np.concatenate([reqs[rid].prompt, np.array(c[:j], np.int32)])
        cache = PM.init_cache(pcfg, 1, len(seq), device="cpu")
        with torch.inference_mode():
            logits = PM.prefill(pcfg, pparams,
                                {"tokens": torch.from_numpy(seq[None])},
                                cache)[0][0]
        top = torch.topk(logits, 2)
        print(f"  request {rid} (prompt family {rid % 3}): new token {j} "
              f"cold {c[j]}, tiered {t[j]}; fp32 logits (no quantized "
              f"pages) cold's {float(logits[c[j]]):.6f}, tiered's "
              f"{float(logits[t[j]]):.6f}, margin "
              f"{float(logits[c[j]] - logits[t[j]]):.3g}; top two "
              f"{top.indices.tolist()} at {[round(float(v), 6) for v in top.values]}")


if __name__ == "__main__":
    main()
