"""The plain reference held to the port's plain CPU path at a tiny size,
and the benchmark's import rules.  Only this test imports both the
reference and ``repro_torch``; the reference itself imports nothing of
the program."""
import ast
from pathlib import Path

import pytest
import torch

from conftest import HERE, tiny_config

CONFIGS = ("starcoder2-3b", "minicpm-2b")


def _port(f, w):
    import run as R
    from bench import weights as W
    return R.port_config(f), W.port_tree(f, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_ports_full_forward(name):
    from bench import weights as W
    from reference.dense import forward
    from repro_torch.models import model as M
    f = tiny_config(name)
    w = W.draw(f, 11, "cpu")
    cfg, tree = _port(f, w)
    # within the window: the training forward applies none
    ids = torch.randint(0, f["vocab_size"], (1, 60),
                        generator=torch.Generator().manual_seed(3))
    port, _ = M.forward_train(cfg, tree, {"tokens": ids}, remat=False)
    ref = forward(f, w, [ids[0]], [torch.arange(60)])[0]
    assert (port[0] - ref).abs().max() < 1e-4 * ref.abs().max()


def test_reference_windows_a_prompt_longer_than_the_window():
    """starcoder2's sliding window (64 lines at the tiny size) against the
    port's prefill of 100 tokens."""
    from bench import weights as W
    from reference.dense import forward
    from repro_torch.models import model as M
    f = tiny_config("starcoder2-3b")
    w = W.draw(f, 13, "cpu")
    cfg, tree = _port(f, w)
    ids = torch.randint(0, f["vocab_size"], (1, 100),
                        generator=torch.Generator().manual_seed(5))
    state = M.init_state(cfg, 1, 128, device="cpu")
    port, _ = M.prefill(cfg, tree, {"tokens": ids}, state)
    ref = forward(f, w, [ids[0]], [torch.tensor([99])])[0]
    assert (port - ref).abs().max() < 1e-4 * ref.abs().max()
    unwindowed = forward(dict(f, sliding_window=None), w, [ids[0]],
                         [torch.tensor([99])])[0]
    assert (unwindowed - ref).abs().max() > 1e-2 * ref.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_prefill_then_decode_through_the_cache(name):
    from bench import weights as W
    from reference.dense import forward
    from repro_torch.models import model as M
    f = tiny_config(name)
    w = W.draw(f, 12, "cpu")
    cfg, tree = _port(f, w)
    ids = torch.randint(0, f["vocab_size"], (1, 70),
                        generator=torch.Generator().manual_seed(4))
    P = 50
    state = M.init_state(cfg, 1, 64, device="cpu")
    logits, state = M.prefill(cfg, tree, {"tokens": ids[:, :P]}, state)
    rows = [logits[0]]
    for t in range(P, 64):
        lg, state = M.decode_step(cfg, tree, ids[:, t:t + 1], state,
                                  torch.tensor(t))
        rows.append(lg[0])
    ref = forward(f, w, [ids[0, :64]], [torch.arange(P - 1, 64)])[0]
    port = torch.stack(rows)
    assert (port - ref).abs().max() < 1e-4 * ref.abs().max()


def test_the_tree_is_the_one_the_port_draws():
    """Same leaves, shapes and dtypes as ``init_params`` gives."""
    from bench import weights as W
    from repro_torch.models import init_params
    for name in CONFIGS:
        f = tiny_config(name)
        cfg, tree = _port(f, W.draw(f, 0, "cpu"))
        mine = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")

        def leaves(t, pre=""):
            if isinstance(t, dict):
                return {k2: v2 for k, v in t.items()
                        for k2, v2 in leaves(v, f"{pre}/{k}").items()}
            if isinstance(t, list):
                return {k2: v2 for i, v in enumerate(t)
                        for k2, v2 in leaves(v, f"{pre}/{i}").items()}
            return {pre: (tuple(t.shape), t.dtype)}
        assert leaves(tree) == leaves(mine)


def test_the_float8_control_strays_further_than_float32():
    from bench import weights as W
    from reference.dense import forward
    f = tiny_config("minicpm-2b")
    w = W.draw(f, 5, "cpu")
    ids = torch.randint(0, f["vocab_size"], (60,),
                        generator=torch.Generator().manual_seed(6))
    rows = torch.arange(60)
    a = forward(f, w, [ids], [rows])[0]
    b = forward(f, w, [ids], [rows])[0]
    low = forward(f, w, [ids], [rows], precision="fp8")[0]
    assert torch.equal(a, b)
    assert (low - a).abs().max() > 1e-3 * a.abs().max()


# -- import rules -------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(HERE)), m)
             for p in HERE.rglob("*.py") for m in _imports(p)
             if m in ("jax", "jaxlib", "flax", "repro")}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(str(p.relative_to(HERE)), m)
             for p in (HERE / "reference").rglob("*.py")
             for m in _imports(p)
             if m not in ("torch", "math", "typing", "__future__")}
    assert not found


def test_the_check_imports_nothing_of_the_program():
    mods = set(_imports(HERE / "bench" / "check.py"))
    assert "repro_torch" not in mods and "repro" not in mods
