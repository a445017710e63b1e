"""The port's serving launcher (``repro_torch.launch.serve``): its copy of
``small`` equals the reference's ``examples/serve_batched.small`` field by
field, and ``main`` serves every ported architecture at ``--reduced`` on the
CPU, printing the reference's line."""
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
    assert sorted(ASSIGNED_ARCHS) == tbase.list_archs() == [
        "chatglm3-6b", "deepseek-v2-236b", "minicpm3-4b", "phi3-mini-3.8b", "qwen3-moe-30b-a3b",
        "stablelm-3b",
    ]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_small_is_the_reference_small(arch):
    assert _fields(serve.small(tbase.get_config(arch))) == _fields(jsmall(jget(arch)))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "internvl2-2b"])
def test_small_keeps_every_family_branch(arch):
    """The SSM, hybrid and VLM branches too, on configs the port does not
    register yet (rebuilt from the reference's fields)."""
    jcfg = jget(arch)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name not in ("quant", "ssm")}
    ssm = tbase.SsmConfig(**dataclasses.asdict(jcfg.ssm)) if jcfg.ssm is not None else None
    want, got = _fields(jsmall(jcfg)), _fields(serve.small(tbase.ModelConfig(**fields, ssm=ssm)))
    assert got == want


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_main_serves_reduced_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--requests", "3", "--new-tokens", "5",
                "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"served 3 requests / 15 tokens in \d+\.\d\ds", line), line
