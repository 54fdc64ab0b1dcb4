"""Boundaries of the port, checked on the CPU.

* No module of ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or ``repro`` (an AST scan, so lazy imports inside functions are
  caught too).
* Entry points run on ``cuda`` by default and raise when there is no card;
  they never fall back to the CPU.
* A kernel wrapper given CPU tensors runs the plain version and counts no
  launch; importing the package builds nothing.
* ``chip_smoke.py`` fails, and prints no result, without a card or alone
  in a directory.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_sees_the_whole_package():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for module in ("core/config.py", "core/spec.py", "kernels/dispatch.py",
                   "kernels/indexing.py", "kernels/flash.py",
                   "kernels/anchor.py", "kernels/stripe_select.py",
                   "kernels/sparse.py", "kernels/ops.py", "models/config.py",
                   "models/layers.py", "models/attention.py",
                   "models/transformer.py", "models/model.py",
                   "models/convert.py", "configs/registry.py",
                   "configs/llama31_8b.py", "serving/engine.py",
                   "launch/serve.py"):
        assert module in names
    for kernel in ("flash", "anchor", "stripe_select", "sparse"):
        assert (PORT / "kernels" / "csrc" / f"{kernel}.cu").exists()


@pytest.fixture
def no_card(monkeypatch):
    """Behave as a machine without a CUDA card, wherever the test runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_cfg():
    from repro_torch.configs import get_reduced_config

    return get_reduced_config("llama31_8b")


@pytest.mark.parametrize("entry", ["init", "init_cache", "params_from_jax",
                                   "serve"])
def test_entry_points_default_to_the_card_and_raise_without_one(no_card, entry):
    from repro_torch.models import convert, model
    from repro_torch.launch import serve

    cfg = _small_cfg()
    calls = {
        "init": lambda: model.init(torch.Generator(), cfg),
        "init_cache": lambda: model.init_cache(cfg, 2, 16),
        "params_from_jax": lambda: convert.params_from_jax({}, cfg),
        "serve": lambda: serve.main(["--arch", "llama31_8b", "--reduced"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_entry_points_run_on_the_cpu_when_asked():
    from repro_torch.core.spec import AttentionSpec
    from repro_torch.models import model

    cfg = dataclasses.replace(_small_cfg(), dtype="float32")
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    logits, _ = model.prefill(params, torch.zeros((1, 8), dtype=torch.int64),
                              cfg, spec=AttentionSpec(algorithm="dense"))
    assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()


def test_wrappers_on_cpu_tensors_run_the_plain_version_uncounted():
    from repro_torch.core.config import AnchorConfig
    from repro_torch.kernels import anchor, build, flash

    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 32, 8), generator=gen)
    k = torch.randn((1, 1, 32, 8), generator=gen)
    before, libs = dict(build.LAUNCHES), dict(build._LIBS)
    out = flash.flash_attention_cuda(q, k, k)
    torch.testing.assert_close(out, flash.flash_attention_torch(q, k, k))
    cfg = AnchorConfig(block_q=16, block_kv=16, step=1)
    for a, b in zip(anchor.anchor_phase_cuda(q, k, cfg),
                    anchor.anchor_phase_torch(q, k, cfg)):
        assert torch.equal(a, b)
    assert dict(build.LAUNCHES) == before
    assert build._LIBS == libs, "a CPU call may build or load nothing"


def test_chip_smoke_fails_without_a_card(no_card, capsys, monkeypatch):
    # main() pins CUDA_VISIBLE_DEVICES to one card; monkeypatch restores it.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {key: val for key, val in os.environ.items() if key != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_no_hq_wide_kv_copy_in_the_sparse_plain_version(monkeypatch):
    """The plain sparse sweep gathers Hkv-wide tiles only: no tensor it
    makes carries the (B, Hq, N, D) shape of a repeated K/V."""
    from repro_torch.core.config import AnchorConfig
    from repro_torch.kernels import ops

    cfg = AnchorConfig(block_q=16, block_kv=16, step=2, theta=3.0)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 64, 8), generator=gen)
    k = torch.randn((1, 1, 64, 8), generator=gen)
    seen = []
    real_gather = torch.gather

    def spy(inp, dim, index, *a, **kw):
        seen.append(tuple(index.shape))
        return real_gather(inp, dim, index, *a, **kw)

    monkeypatch.setattr(torch, "gather", spy)
    ops.anchor_attention(q, k, k, cfg)
    assert seen and all(shape[1] == 1 for shape in seen), seen
    assert np.prod(seen[0]) < q.numel()
