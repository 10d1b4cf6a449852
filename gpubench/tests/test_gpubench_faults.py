"""A whole run with the program broken underneath the timed path, past
the harness's look for a card: `correct` has to come out false for each
fault a cell can have (an answer altered where it is produced)."""

import types

import numpy as np
import pytest

from tiny import CELLS, run_cell


class Broken:
    """The program with one fault applied to every result."""

    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def recording(self):
        return self.program.recording()

    def __getattr__(self, entry):
        call = getattr(self.program, entry)
        return lambda *args: self.fault(call(*args))


def level_altered(res):
    """One coded byte of the scan changed."""
    data = bytearray(res.compressed_data)
    i = len(data) - 40
    data[i] = 0x55 if data[i] != 0x55 else 0x56
    return types.SimpleNamespace(**{**vars(res), "compressed_data":
                                    bytes(data)})


def quality_altered(res):
    """The reported quality off by one."""
    return types.SimpleNamespace(**{**vars(res), "jpeg_quality":
                                    res.jpeg_quality + 1})


def ssim_altered(res):
    return types.SimpleNamespace(**{**vars(res), "ssim": res.ssim - 0.01})


def decode_altered(res):
    """The decoded image one level off in a corner."""
    img = np.array(res.image)
    img[:8, :8, :3] ^= 1
    return types.SimpleNamespace(**{**vars(res), "image": img})


FAULTS = [(w, f) for w in CELLS
          for f in (level_altered, quality_altered, ssim_altered)]
FAULTS += [(w, decode_altered) for w in ("photo12mp.file",
                                         "photo12mp.file_rotated")]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_fault_is_not_correct(workload, fault, program):
    rc, line = run_cell(workload, system=Broken(program, fault))
    assert rc == 0
    assert line["correct"] is False


def test_the_unbroken_program_is_correct(program):
    rc, line = run_cell("photo12mp.file", system=Broken(program,
                                                        lambda r: r))
    assert rc == 0 and line["correct"] is True
