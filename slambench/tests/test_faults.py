"""The comparison deciding `correct` fails a run whose timed path is
broken underneath: the harness's look for a chip is skipped and the rest
of a run is driven on the CPU (the system's plain versions) at a size a
test run holds, with each planted fault of `slambench.control`.

Monocular cells run at half size (320x240, the camera and the world's
texels scaled with it) for the mix's set-up frames and 40 window frames; the fleet at 4
streams over a 12-frame clip.  The limits are the cells' own."""
import time

import pytest
import torch

from slambench import control
from slambench import run as R

BENCH = R.load_json(R.ROOT / "BENCHMARK.json")


def small(cell_name: str):
    _, _, cfg, mix, limits = R.load_cell(cell_name)
    if cfg["driver"] == "mono":
        cfg["shape"] = [240, 320]
        for k in ("fx", "fy", "cx", "cy"):
            cfg["camera"][k] *= 0.5
        cfg["world"]["tex_size"] //= 2
        cfg["world"]["tex_per_meter"] *= 0.5
        mix["max_rate_hz"], mix["archive_warmup"] = 1.0, 0
        seconds = 40.0
    else:
        cfg["streams"] = 4
        mix["path"]["clip"] = mix["setup_frames"] = 12
        seconds = 3.0
    return cfg, mix, limits, seconds


def correct(cell_name: str, mode: str, seed: int = 2 ** 31 + 7) -> bool:
    torch.manual_seed(0)
    cfg, mix, limits, seconds = small(cell_name)
    run, sess, _ = R.measure(cfg, mix, seed, seconds, False, torch.device("cpu"),
                             time.perf_counter(),
                             session_hook=control.window_hook(cfg["driver"], mode))
    assert run.frames > 0
    ok, _ = R.judge(cfg, sess, limits)
    return ok


MONO = [w["name"] for w in BENCH["workloads"] if w["config"] == "tum_fr3_mono"]
FLEET = [w["name"] for w in BENCH["workloads"] if w["config"] == "tum_fr3_fleet16"]


@pytest.mark.parametrize("cell", MONO)
@pytest.mark.parametrize("mode", ["control", "unchanged", "altered"])
def test_mono_fault_is_not_correct(cell, mode):
    assert not correct(cell, mode)


@pytest.mark.parametrize("cell", FLEET)
@pytest.mark.parametrize("mode", ["control", "unchanged", "half_batch", "altered"])
def test_fleet_fault_is_not_correct(cell, mode):
    assert not correct(cell, mode)


@pytest.mark.parametrize("cell", MONO + FLEET)
def test_sound_is_correct(cell):
    assert correct(cell, "sound")
