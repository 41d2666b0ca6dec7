"""End-to-end parity of the port's paged continuous serving with the JAX
package's: the same workload, the same bridged weights (reduced llama2-70b,
fp32), both InferenceEngines on a VirtualClock over a two-stage [1, 1]
pipeline. Greedy token streams and the ServeStats counters must be
identical. The workloads mirror scripts/smoke_serving.py's ``serving`` and
``prefix`` suites, plus a pool small enough to force preemption."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock

COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions")


def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=4,
                              seed=1)


def _shared(mod, vocab):
    return mod.shared_prefix_workload(rate=4.0, duration=2.0, vocab=vocab,
                                      shared_len=24, unique_len=6,
                                      out_len=4, seed=3)


WORKLOADS = {
    # (a) paged continuous serving
    "serving": (_synth, dict(block_size=8)),
    # (b) prefix caching + chunked prefill on a shared system prompt
    "prefix": (_shared, dict(block_size=8, prefix_caching=True,
                             prefill_chunk=16)),
    # (c) (a) over pools too small for every admitted generation: with
    # 2-token blocks the admission headroom (one block) is shorter than
    # out_len, so decode growth runs the pools dry and preempts
    "preempt": (_synth, dict(block_size=2, stage_blocks=[14, 14])),
}


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("llama2-70b").reduced()
    return cfg, jax.tree.map(np.asarray,
                             JM.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_port_serves_token_identical_to_reference(weights, name):
    cfg, tree = weights
    make, kw = WORKLOADS[name]
    common = dict(n_slots=4, max_len=48, **kw)
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    jreqs = make(jreq, cfg.vocab_size)
    jstats = JEngine(cfg, asg, params=jax.tree.map(jnp.asarray, tree),
                     policy="continuous", cache_layout="paged",
                     **common).serve(jreqs, deadline=120.0, clock=JClock())

    pcfg = port_config("llama2-70b").reduced()
    pasg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 1), port_plan.StagePlan([1], 1)])])
    preqs = make(preq, pcfg.vocab_size)
    pstats = PEngine(pcfg, pasg,
                     params=bridge.params_from_numpy(tree, device="cpu"),
                     device="cpu", cache_layout="paged",
                     **common).serve(preqs, deadline=120.0, clock=PClock())

    assert len(preqs) == len(jreqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        first = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                      if x != y), None)
        assert list(a.output) == list(b.output), \
            f"request {a.rid}: streams part at token {first}: " \
            f"{list(a.output)} vs {list(b.output)}"
    for c in COUNTERS:
        assert getattr(pstats, c) == getattr(jstats, c), c
    if name == "prefix":
        assert pstats.prefix_hits > 0
    if name == "preempt":
        assert pstats.preemptions > 0
