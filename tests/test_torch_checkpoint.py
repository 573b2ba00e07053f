"""The port's checkpoints (``repro_torch.checkpoint``) in the JAX package's
msgpack layout: the bytes the port writes equal ``msgpack.packb``'s (the
JAX package's ``save_tree`` of the same state) for the train state of a
dense, an MoE and a hybrid config and for the critic's state; a checkpoint
written by either package loads in the other, leaf for leaf and bit for
bit (bf16 included); ``latest_checkpoint``'s order; and the codec's
pieces against ``msgpack`` itself, which the port does not import."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import checkpoint as jckpt
from repro.models import get_api as jget_api
from repro.train import critic as jcritic
from repro.train import optimizer as jopt
from repro_torch.checkpoint import latest_checkpoint, load_tree, save_checkpoint, save_tree
from repro_torch.checkpoint import store
from repro_torch.convert import params_to_numpy, state_from_jax
from repro_torch.models import ModelConfig
from repro_torch.train.optimizer import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = {"dense": "qwen3-4b", "moe": "qwen3-moe-235b-a22b",
         "hybrid": "recurrentgemma-9b", "critic": "qwen3-4b"}


def _jax_state(kind, seed):
    """A bf16 JAX train state (the critic's for ``kind="critic"``) whose
    optimizer has moved: m and v seeded noise, step 3."""
    cfg = tiny(ARCHS[kind])
    japi = jget_api(cfg)
    key = jax.random.PRNGKey(seed)
    if kind == "critic":
        state = jcritic.make_critic_train_state(japi, key)
    else:
        params = japi.init(key)
        state = {"params": params, "opt": jopt.init_opt_state(params)}
    rng = np.random.default_rng(seed)

    def moved(opt):
        noise = {k: jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), opt[k])
            for k in ("m", "v")}
        return dict(opt, step=np.int32(3), **noise)
    state = dict(state, opt=moved(state["opt"]))
    if "vopt" in state:
        state["vopt"] = moved(state["vopt"])
    return ModelConfig(**dataclasses.asdict(cfg)), jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module", params=list(ARCHS))
def states(request):
    cfg, jstate = _jax_state(request.param, 0)
    return request.param, cfg, jstate, state_from_jax(jstate, "cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.ndim else a.reshape(1).view(np.uint8)


def _assert_bit_equal(want_tree, got_tree):
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = jax.tree_util.tree_leaves(got_tree)
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert np.asarray(w).dtype == np.asarray(g).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(_bits(w), _bits(g),
                                      err_msg=jax.tree_util.keystr(path))


def test_bytes_equal_msgpack(states, tmp_path):
    kind, cfg, jstate, tstate = states
    save_tree(str(tmp_path / "port"), tstate, cfg=cfg)
    jckpt.save_tree(str(tmp_path / "jax"), jstate)
    got = (tmp_path / "port" / "tree.msgpack").read_bytes()
    want = (tmp_path / "jax" / "tree.msgpack").read_bytes()
    assert got == want
    # the JAX package's file is msgpack.packb's bytes of its leaves
    leaves = jax.tree_util.tree_leaves(jstate)
    assert msgpack.unpackb(want, raw=False)[0]["dtype"] == str(np.asarray(leaves[0]).dtype)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert len(meta["treedef"]["leaves"]) == len(leaves)
    if kind != "critic":
        assert any(d == "bfloat16" for _, d, _ in meta["treedef"]["leaves"])


def test_port_checkpoint_loads_in_jax(states, tmp_path):
    kind, cfg, jstate, tstate = states
    path = save_checkpoint(str(tmp_path), 7, tstate, cfg=cfg, note="port")
    assert path == str(tmp_path / "step_00000007")
    meta = json.loads(Path(path, "meta.json").read_text())
    assert meta["step"] == 7 and meta["note"] == "port"
    loaded = jckpt.load_tree(path, jstate)
    _assert_bit_equal(jstate, loaded)
    want = params_to_numpy(tstate["params"], cfg)
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree_util.tree_leaves(loaded["params"])):
        np.testing.assert_array_equal(w, np.asarray(g, np.float32),
                                      err_msg=jax.tree_util.keystr(p))


def test_jax_checkpoint_loads_in_port(states, tmp_path):
    kind, cfg, jstate, tstate = states
    jckpt.save_checkpoint(str(tmp_path), 3, jstate)
    like = state_from_jax(_jax_state(kind, 1)[1], "cpu")
    path = latest_checkpoint(str(tmp_path))
    got = load_tree(path, like, cfg=cfg)
    want, have, ref = tree_leaves(tstate), tree_leaves(got), tree_leaves(like)
    assert len(want) == len(have) == len(ref)
    for w, g, r in zip(want, have, ref):
        if isinstance(r, int):
            assert g == w == 3 and isinstance(g, int)
            continue
        assert g.dtype == r.dtype and g.device == r.device and g is not r
        assert torch.equal(g.view(torch.uint8) if g.dim() else g.reshape(1).view(torch.uint8),
                           w.view(torch.uint8) if w.dim() else w.reshape(1).view(torch.uint8))
    assert isinstance(got["params"]["blocks"], list)
    assert len(got["params"]["blocks"]) == cfg.num_layers


def test_latest_checkpoint_ordering(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "step": 5}
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for step in (2, 10, 1):
        save_checkpoint(str(tmp_path), step, tree)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_00000010")
    assert jckpt.latest_checkpoint(str(tmp_path)) == latest_checkpoint(str(tmp_path))
    back = load_tree(latest_checkpoint(str(tmp_path)), tree)
    assert torch.equal(back["w"], tree["w"]) and back["step"] == 5


def test_load_checks_shapes_and_leaf_counts(tmp_path):
    tree = {"a": torch.zeros(2, 3), "b": [torch.ones(4, dtype=torch.bfloat16), None]}
    save_tree(str(tmp_path), tree)
    with pytest.raises(ValueError, match="shape"):
        load_tree(str(tmp_path), {"a": torch.zeros(3, 2), "b": [torch.ones(4), None]})
    with pytest.raises(ValueError, match="mismatch"):
        load_tree(str(tmp_path), {"a": torch.zeros(2, 3)})
    back = load_tree(str(tmp_path), {"a": torch.ones(2, 3, dtype=torch.float64),
                                     "b": [torch.zeros(4, dtype=torch.bfloat16), None]})
    assert back["a"].dtype == torch.float64 and not back["a"].any()
    assert back["b"][1] is None and torch.equal(back["b"][0], tree["b"][0])
    hybrid = state_from_jax(_jax_state("hybrid", 0)[1], "cpu")
    with pytest.raises(ValueError, match="cfg"):
        save_tree(str(tmp_path / "h"), hybrid)


# ---------------------------------------------------------------------------
# the codec against msgpack
# ---------------------------------------------------------------------------

def _pack(x) -> bytes:
    """The port's encoder over the layout's types."""
    if isinstance(x, dict):
        return store._map(len(x)) + b"".join(_pack(k) + _pack(v) for k, v in x.items())
    if isinstance(x, list):
        return store._array(len(x)) + b"".join(_pack(v) for v in x)
    if isinstance(x, str):
        return store._str(x)
    if isinstance(x, bytes):
        return store._bin_header(len(x)) + x
    return store._int(x)


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
VALUES = ([[i] for i in INTS]
          + [["s" * n] for n in (0, 31, 32, 255, 256, 65536)]
          + [[b"\x01" * n] for n in (0, 255, 256, 65535, 65536)]
          + [[list(range(n))] for n in (15, 16, 65536)]
          + [[{str(i): i for i in range(n)}] for n in (15, 16)]
          + [[{"dtype": "bfloat16", "shape": [2, 3], "data": b"\x00" * 12}]])


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v[0]).__name__)
def test_codec_matches_msgpack(value, tmp_path):
    want = msgpack.packb(value, use_bin_type=True)
    assert _pack(value) == want
    path = tmp_path / "v.msgpack"
    path.write_bytes(want)
    with open(path, "rb") as f:
        got = store._Reader(f).value()
    back = msgpack.unpackb(want, raw=False)
    if isinstance(value[0], bytes):
        assert [bytes(got[0])] == back
    elif isinstance(value[0], dict) and "data" in value[0]:
        assert dict(got[0], data=bytes(got[0]["data"])) == back[0]
    else:
        assert got == back


def test_a_leaf_over_4_gib_is_refused():
    assert store._bin_header(2**32 - 1)[0] == 0xC6
    with pytest.raises(ValueError, match="4 GiB"):
        store._bin_header(2**32)


def test_the_port_imports_no_msgpack():
    code = ("import sys, repro_torch.checkpoint\n"
            "assert 'msgpack' not in sys.modules, 'msgpack imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
