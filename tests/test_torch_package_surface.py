"""The port's package-level surface against univid_tpu's, on the CPU: each
`__init__.py` re-exports what its JAX counterpart does (less the by-design
names of ROADMAP queue 1), the size tables of core/config.py equal JAX's,
`count_params` counts what JAX's does on the same parameters (the tiny DiT
through convert.py, t2v-1.3B from its shapes on the meta device), and each
package imports alone without JAX or univid_tpu.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import univid_tpu.core.config as jconfig
import univid_tpu_torch.core.config as tconfig
from univid_tpu.core.nn import count_params as j_count_params
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu_torch import convert
from univid_tpu_torch.core.nn import count_params
from univid_tpu_torch.models.wan.dit import WanDiT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["core", "ops", "kernels", "pipelines", "train", "models/wan",
            "models/fusion", "models/bagel", "reflection"]
# ROADMAP queue 1's "Not ported, by design" names these files re-export:
# the port's modules draw their weights in their constructors
BY_DESIGN = {"models/wan": {"init_wan_dit"}}


def _exports(path):
    """The names an __init__.py imports from its modules."""
    tree = ast.parse(open(path).read())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_init_reexports_match_jax(pkg):
    """The port's __init__.py exports JAX's names less the by-design ones,
    and each is importable from the package."""
    want = _exports(os.path.join(REPO, "univid_tpu", pkg, "__init__.py"))
    got = _exports(os.path.join(REPO, "univid_tpu_torch", pkg,
                                "__init__.py"))
    assert want, pkg
    assert got == want - BY_DESIGN.get(pkg, set())
    mod = __import__("univid_tpu_torch." + pkg.replace("/", "."),
                     fromlist=sorted(got))
    for name in got:
        assert getattr(mod, name) is not None, name


def test_kernels_attention_is_the_module_and_the_function():
    """`univid_tpu_torch.kernels.attention` stays the dispatcher module (the
    port's own imports read it) and, called, is the function, as JAX's
    package-level `attention` is."""
    from univid_tpu_torch.kernels import attention
    import univid_tpu_torch.kernels.attention as module
    assert attention is module and callable(attention)
    q = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 24, 2, 16)).astype(np.float32))
    assert torch.equal(attention(q, q, q), module.attention(q, q, q))


def test_size_tables_match_jax():
    assert tconfig.SIZE_CONFIGS == jconfig.SIZE_CONFIGS
    assert tconfig.MAX_AREA_CONFIGS == jconfig.MAX_AREA_CONFIGS
    assert tconfig.SUPPORTED_SIZES == jconfig.SUPPORTED_SIZES
    from univid_tpu_torch.core import MAX_AREA_CONFIGS, SIZE_CONFIGS
    assert MAX_AREA_CONFIGS["1280*704"] == 1280 * 704
    assert set(SIZE_CONFIGS) >= set(tconfig.SUPPORTED_SIZES["ti2v-5B"])


def test_count_params_matches_jax_tiny_through_convert():
    """The tiny DiT's JAX tree and the module convert.py builds from it:
    the same count, over the module and over its state dict."""
    cfg = jconfig.WAN_CONFIGS["tiny"].dit
    params = jax.tree_util.tree_map(
        np.asarray, init_wan_dit(jax.random.PRNGKey(0), cfg))
    model = convert.dit_from_jax(params, tconfig.WAN_CONFIGS["tiny"].dit,
                                 device="cpu")
    want = j_count_params(params)
    assert count_params(model) == count_params(model.state_dict()) == want


def test_count_params_matches_jax_t2v_13b():
    """t2v-1.3B at full size without drawing it: JAX's count over
    jax.eval_shape of its init against the port's WanDiT on the meta
    device (its ~1.3 B elements)."""
    cfg = jconfig.WAN_CONFIGS["t2v-1.3B"].dit
    shapes = jax.eval_shape(lambda: init_wan_dit(jax.random.PRNGKey(0), cfg))
    want = j_count_params(shapes)
    model = WanDiT(tconfig.WAN_CONFIGS["t2v-1.3B"].dit, dtype=torch.float32,
                   device="meta")
    assert count_params(model) == want
    assert 1.2e9 < want < 1.5e9


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_imports_alone_without_jax(pkg):
    """`import univid_tpu_torch.<pkg>` in a fresh process (its re-exports
    and what they import) pulls in neither jax nor univid_tpu."""
    name = "univid_tpu_torch." + pkg.replace("/", ".")
    code = (f"import sys, {name}\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'univid_tpu' or m.startswith('univid_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
