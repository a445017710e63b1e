"""The port's serving launcher (``repro_torch.launch.serve``): its copy of
``small`` equals the reference's ``examples/serve_batched.small`` field by
field, and ``main`` serves at ``--reduced`` on the CPU every architecture
that the reference's launcher serves, printing the reference's line, and
fails as the reference's does on the other two: hubert-xlarge is
encoder-only (the ``Engine``'s ``ValueError``) and internvl2-2b needs patch
embeddings that the ``Engine``'s token-only prefill does not give
(``KeyError: 'patches'``)."""
from __future__ import annotations

import dataclasses
import re

import pytest

from repro_torch.configs import base as tbase
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.launch import serve

from examples.serve_batched import small as jsmall
from repro.configs import get_config as jget


def _fields(cfg) -> dict:
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_the_ported_archs_are_the_six():
    """All ten of the reference's archs, in its order (the name is from when
    the port had six)."""
    from repro.configs.archs import ASSIGNED_ARCHS as J_ARCHS

    assert ASSIGNED_ARCHS == J_ARCHS
    assert sorted(ASSIGNED_ARCHS) == tbase.list_archs() == [
        "chatglm3-6b", "deepseek-v2-236b", "hubert-xlarge", "internvl2-2b", "mamba2-1.3b",
        "minicpm3-4b", "phi3-mini-3.8b", "qwen3-moe-30b-a3b", "stablelm-3b", "zamba2-1.2b",
    ]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_small_is_the_reference_small(arch):
    assert _fields(serve.small(tbase.get_config(arch))) == _fields(jsmall(jget(arch)))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "internvl2-2b"])
def test_small_keeps_every_family_branch(arch):
    """The SSM, hybrid and VLM branches, on configs rebuilt from the
    reference's fields (the registered ones are held above)."""
    jcfg = jget(arch)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name not in ("quant", "ssm")}
    ssm = tbase.SsmConfig(**dataclasses.asdict(jcfg.ssm)) if jcfg.ssm is not None else None
    want, got = _fields(jsmall(jcfg)), _fields(serve.small(tbase.ModelConfig(**fields, ssm=ssm)))
    assert got == want


REFUSED = {"hubert-xlarge": (ValueError, "encoder-only"), "internvl2-2b": (KeyError, "patches")}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_main_serves_reduced_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--new-tokens", "5", "--device", "cpu"]
    if arch in REFUSED:
        error, match = REFUSED[arch]
        with pytest.raises(error, match=match):
            serve.main(argv)
        return
    serve.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"served 3 requests / 15 tokens in \d+\.\d\ds", line), line
