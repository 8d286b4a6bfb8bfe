"""The serving driver: ``repro_torch.launch.serve.main`` against the JAX
package's ``repro.launch.serve.main`` at the same arguments, the port
given the reference's seed-0 weights through ``params_from_jax`` and run
on the CPU (``--device cpu``). Every printed line must be equal (the
placement, each pipeline's weight and round, the finished requests, their
tokens, the migrations, the rounds, the virtual clock and the prefill
traces) but for the wall time and the tok/s by wall, with an
interruption and without.
"""

import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.launch import serve as jserve
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax

ARCH = "qwen2-0.5b"
WALL = re.compile(r"in [0-9.]+s wall \([0-9.]+ tok/s\)")


def _lines(text):
    return [WALL.sub("in <wall>", line) for line in text.splitlines()]


@pytest.mark.parametrize("extra", [[], ["--interrupt-at", "3"]])
def test_serve_launcher_prints_the_references_lines(monkeypatch, extra):
    argv = ["--arch", ARCH, "--requests", "6", "--max-new-tokens", "5",
            *extra]
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        jserve.main()
    jcfg = jax_config(ARCH).reduced()
    jparams = jax_build(jcfg, remat=False, attn_chunk=0).init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_config(ARCH).reduced(), device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reqs = serve.main(argv + ["--device", "cpu"], params=params)
    got, ref = _lines(out.getvalue()), _lines(ref_out.getvalue())
    assert got == ref
    assert len(reqs) == 6 and all(r.done for r in reqs)
    assert any(r.migrations for r in reqs) == bool(extra)
