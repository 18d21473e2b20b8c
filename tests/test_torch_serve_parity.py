"""The port's ``ServeEngine`` against the JAX package's on the same weights
and prompts (greedy tokens equal, through a preemption), and the port's
``launch.serve`` on the CPU resuming identically after a preemption."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeEngine

CPU = torch.device("cpu")


def f32_cfg(get):
    return dataclasses.replace(get("olmo_1b").scaled_down(), dtype="float32")


def test_tokens_equal_reference_engine():
    jcfg, tcfg = f32_cfg(j_get_config), f32_cfg(get_config)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=96)
    batch = make_batch(jcfg, ShapeConfig("t", 32, 2, "prefill"))
    want = JEngine(jmodel, jparams, snapshot_every=4).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 10, crash_at=5)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    got = ServeEngine(get_model(tcfg, CPU), tparams, snapshot_every=4,
                      device=CPU).generate(batch, 10, crash_at=5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_launch_serve_on_cpu_resumes_identically():
    kw = dict(batch=2, prompt_len=16, tokens=6, snapshot_every=2, device="cpu")
    clean = tserve.serve(**kw)
    assert clean.shape == (2, 6)
    np.testing.assert_array_equal(clean, tserve.serve(crash_at=3, **kw))
