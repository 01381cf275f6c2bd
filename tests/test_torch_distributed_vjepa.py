"""The port's V-JEPA training on several gloo ranks on the CPU: the step
(student and EMA teacher) under dp, fsdp, tp (2 ranks) and fsdp+tp (4
ranks) against the JAX package's sharded step on the 8-device CPU mesh
and against the port's own single-process step on the same global batch,
also with gradient accumulation 2 and the 8-bit AdamW, the clip active
(the helpers of tests/test_torch_distributed_train.py)."""

import pytest
import torch

from test_torch_distributed_train import (
    POLICIES,
    check_against_jax,
    check_against_one_process,
    run_family,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    return run_family("vjepa", eight_devices, tmp_path_factory)


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_vjepa_step_matches_jax(runs, policy):
    check_against_jax(runs, "vjepa", policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["vjepa", "vjepa8"])
def test_sharded_vjepa_step_matches_one_process(runs, name, policy):
    check_against_one_process(runs, name, policy)
