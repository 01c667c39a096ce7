"""PyTorch port: ``ServingEngine(sync_every=k)`` against the JAX engine.

``sync_every`` decode steps run between the host's done-mask polls. For
k = 1, 2 and 4, on gemma2-2b's smoke config and on rwkv6-3b's (the
recurrent state path), the port's continuous engine and JAX's serve the
same ragged requests (more requests than slots, budgets and an eos that
end rows inside a window) from the same parameters, and agree on:
the outputs; ``decode_steps``; ``len(step_wall_s)`` (one entry a
window); ``step_tokens`` (``emit_n * k`` a window: a row finishing
mid-window overcounts by at most k - 1, as in JAX); ``prefills`` and
``tokens``. The outputs are those of ``sync_every=1``: a row done inside
a window stops writing (the step's emit mask).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

LENS, BUDGETS = (3, 9, 5, 12, 7), (6, 3, 8, 5, 4)
EOS_ROW, EOS_AT = 2, 2      # row 2's eos: its 3rd token; it stops early


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg = jax_configs.get_smoke_config(arch)
        jparams = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke_config(arch)
        _MODELS[arch] = (cfg, jcfg, jparams,
                         params_from_jax(_flat(jparams), cfg, device="cpu"))
    return _MODELS[arch]


def _requests(cls, cfg, eos=None):
    rng = np.random.default_rng(1)
    reqs = [cls(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                max_new_tokens=m) for n, m in zip(LENS, BUDGETS)]
    if eos is not None:
        reqs[EOS_ROW].eos_id = eos
    return reqs


def _jax_serve(arch, k, eos=None):
    cfg, jcfg, jparams, _ = _models(arch)
    eng = JaxServingEngine(jcfg, jparams, max_batch=3, max_seq=64,
                           page_size=4, sync_every=k)
    reqs = eng.serve(_requests(JaxRequest, cfg, eos))
    return reqs, eng.last_stats


@functools.lru_cache(maxsize=None)
def _eos(arch):
    """A token row EOS_ROW emits at EOS_AT without an eos (JAX, k = 1),
    and the length its output stops at with that eos."""
    out = _jax_serve(arch, 1)[0][EOS_ROW].output
    return out[EOS_AT], out.index(out[EOS_AT]) + 1


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-3b"])
def test_sync_every_matches_jax_engine(arch, k):
    cfg, _, _, params = _models(arch)
    eos, stop = _eos(arch)
    jreqs, jstats = _jax_serve(arch, k, eos)
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=64, page_size=4,
                        device="cpu", sync_every=k)
    assert eng.sync_every == k
    reqs = eng.serve(_requests(Request, cfg, eos))
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    stats = eng.last_stats
    assert stats.decode_steps == jstats.decode_steps
    assert len(stats.step_wall_s) == len(jstats.step_wall_s)
    assert stats.step_tokens == list(jstats.step_tokens)
    assert (stats.prefills, stats.tokens) == (jstats.prefills, jstats.tokens)
    assert len(reqs[EOS_ROW].output) == stop < BUDGETS[EOS_ROW]
    assert reqs[EOS_ROW].output[-1] == eos
    # a window's steps are counted one by one; its tokens k to a row
    assert stats.decode_steps == k * len(stats.step_wall_s)
    assert all(t % k == 0 for t in stats.step_tokens)
    assert sum(stats.step_tokens) >= stats.tokens - stats.prefills


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-3b"])
def test_outputs_do_not_depend_on_sync_every(arch):
    cfg, _, _, params = _models(arch)
    outs = {}
    for k in (1, 3):
        eng = ServingEngine(cfg, params, max_batch=2, max_seq=32, page_size=4,
                            n_pages=16, device="cpu", sync_every=k)
        outs[k] = [r.output for r in eng.serve(_requests(Request, cfg))]
    assert outs[1] == outs[3]
    assert [len(o) for o in outs[1]] == list(BUDGETS)


def test_sync_every_below_one_is_one():
    cfg, _, _, params = _models("gemma2-2b")
    assert ServingEngine(cfg, params, max_seq=32, device="cpu",
                         sync_every=0).sync_every == 1
