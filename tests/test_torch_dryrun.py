"""The port's dry-run (``repro_torch.launch.dryrun``): full-width cells on
the fake (16, 16) mesh of 256 ranks, on fake tensors (nothing allocated),
and the per-device state bytes a cell's specs give."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.train import step as TS

HBM = 80e9


@pytest.mark.parametrize("arch,shape", [("grok-1-314b", "decode_32k"),
                                        ("mamba2-780m", "train_4k")])
def test_full_width_cell_runs_on_the_fake_mesh(arch, shape, tmp_path):
    r = DR.run_cell(arch, shape, out_dir=str(tmp_path))
    mem = r["memory"]
    assert mem["argument_bytes"] == mem["argument_bytes_from_specs"]
    assert 0 < mem["argument_bytes"] < HBM
    assert r["devices"] == 256 and r["mesh"] == "pod16x16"
    assert r["collectives"]["total_bytes"] > 0
    assert r["dispatch_cost"]["dot_flops"] > 0
    rl = r["roofline"]
    assert rl["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                rl["collective_s"]) > 0
    assert r["params"] == get_config(arch).param_count()
    assert (tmp_path / f"{arch}__{shape}__pod16x16.json").exists()


def test_grok_train_state_bytes_come_from_the_specs():
    """grok-1-314b x train_4k: FSDP shards every large leaf over all 256
    ranks, so a device holds about 314e9 x 2 / 256 = 2.5 GB of bf16
    parameters, plus Adafactor's factored slots."""
    arch = "grok-1-314b"
    cfg = get_config(arch)
    with M.fake_group(256):
        mesh = M.make_production_mesh(device="cpu")
        with FakeTensorMode():
            state = TS.init_state(torch.Generator().manual_seed(0), cfg,
                                  DR.train_config_for(arch), "cpu")
        specs = SH.state_specs(cfg, state, mesh)
        total = DR.spec_bytes(state, specs, mesh)
        params = DR.spec_bytes(state["params"], specs["params"], mesh)
        slots = DR.spec_bytes(state["opt"], specs["opt"], mesh)
    assert SH.use_fsdp(cfg)
    assert params == pytest.approx(cfg.param_count() * 2 / 256, rel=0.1)
    assert 0 < slots < params
    assert total == params + slots + 4 and total < HBM


def test_cli_skips_and_reports_failures(capsys):
    assert DR.main(["--arch", "qwen3-4b", "--shape", "long_500k"]) == 0
    assert "SKIP qwen3-4b x long_500k" in capsys.readouterr().out
    assert DR.main(["--arch", "no-such-arch", "--shape", "train_4k"]) == 1
    assert "1 FAILURES" in capsys.readouterr().out
