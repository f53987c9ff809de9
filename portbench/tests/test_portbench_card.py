"""On the card (``python -m pytest -m card portbench/tests``), at each
cell's own size, on three seeds: the program's served tokens come out as
correct, and the control (the reference in fp8 in the program's place)
and each sampler fault of a sampling cell come out as not correct through
the cell's own verdict. Skips without a CUDA card."""

import json

import pytest
import torch

from portbench import check
from portbench import run as R
from tiny import CELLS


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_holds_and_control_breaks_the_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = json.loads((R.HERE / "workloads" / f"{cell}.json").read_text())[
        "check"]

    def sources(ref, seed):
        out = {"control": check.control_source(ref, seed)}
        if c.get("sample_sampled"):
            out.update({k: make(seed) for k, make in check.FAULTS.items()
                        if k != "temp_1"})
        return out

    for seed in (101, 2**33 + 7, 909090):
        out = R.run_cell(cell, seed, 8.0, False, sources=sources)
        rec = out["record"]
        assert out["result"]["correct"], rec["compared"]
        for name, nums in rec["others"].items():
            assert not nums["correct"], (name, nums)
