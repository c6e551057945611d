"""``launch/serve --smoke --cpu`` on every non-dense arch prints the
reference launcher's latency lines (the clock is abstract, so they are
equal), and feeds the frontend stub's patch embeddings to the VLM."""

import re
import warnings

import numpy as np
import pytest

from repro.launch import serve as jax_launch
from repro_torch import configs
from repro_torch.launch import serve as launch
from repro_torch.models import frontends

NON_DENSE = [
    "musicgen-medium",
    "mixtral-8x22b",
    "kimi-k2-1t-a32b",
    "falcon-mamba-7b",
    "llama-3.2-vision-11b",
    "jamba-v0.1-52b",
]


def _latency_lines(text):
    """The policy lines, without the port's wall time."""
    return [re.sub(r"\s+wall=\S+$", "", ln) for ln in text.splitlines() if "finished=" in ln]


@pytest.mark.parametrize("arch", NON_DENSE)
def test_launcher_prints_the_reference_latency_lines(arch, capsys):
    args = ["--arch", arch, "--requests", "5"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # its legacy deadline=
        assert jax_launch.main(args) == 0
    want = _latency_lines(capsys.readouterr().out)
    assert launch.main(args + ["--smoke", "--cpu"]) == 0
    got = _latency_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want


def test_launcher_feeds_patch_embeddings_to_the_vlm(monkeypatch):
    seen = []
    real = launch.ServeEngine

    def spy(cfg, params, ecfg, vision=None):
        seen.append(vision)
        return real(cfg, params, ecfg, vision=vision)

    monkeypatch.setattr(launch, "ServeEngine", spy)
    one = ["--smoke", "--cpu", "--requests", "1", "--policy", "eft"]
    assert launch.main(["--arch", "llama-3.2-vision-11b"] + one) == 0
    cfg = configs.get_config("llama-3.2-vision-11b", smoke=True)
    assert np.array_equal(seen[0], frontends.fake_patch_embeddings(cfg, 1)[0])
    assert launch.main(["--arch", "mixtral-8x22b"] + one) == 0
    assert seen[1] is None
