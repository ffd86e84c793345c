"""The build key of lighthouse_tpu_torch.ops.cuda_build.CudaLibrary: a
kernel is rebuilt when its source or any header it reaches changes,
headers included by headers too. Runs on the CPU: the key needs no nvcc."""

import shutil

from lighthouse_tpu_torch.ops.cuda_build import CSRC, CudaLibrary


def _library(tmp_path) -> CudaLibrary:
    """A source in a tmp csrc that includes the G2 team header, itself
    including bls381_field.cuh and mont_cs.cuh (the real headers)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("g2_team.cuh", "bls381_field.cuh", "mont_cs.cuh"):
        shutil.copy(CSRC / name, csrc / name)
    (csrc / "k.cu").write_text('#include "g2_team.cuh"\nint k() { return 0; }\n')
    return CudaLibrary(str(csrc / "k.cu"), {})


def test_key_follows_nested_headers(tmp_path):
    lib = _library(tmp_path)
    key = lib._key()
    assert lib._key() == key  # stable
    nested = tmp_path / "csrc" / "mont_cs.cuh"
    nested.write_text(nested.read_text() + "// an edit\n")
    edited = lib._key()
    assert edited != key
    field = tmp_path / "csrc" / "bls381_field.cuh"
    field.write_text(field.read_text().replace("#pragma once", "#pragma once\n// another edit", 1))
    assert lib._key() not in (key, edited)


def test_key_of_a_header_that_includes_itself(tmp_path):
    """A cycle of includes ends (each file is hashed once), and an edit to
    the header still changes the key."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    header = csrc / "h.cuh"
    header.write_text('#pragma once\n#include "h.cuh"\n')
    (csrc / "a.cu").write_text('#include "h.cuh"\n#include "h.cuh"\n')
    lib = CudaLibrary(str(csrc / "a.cu"), {})
    key = lib._key()
    header.write_text(header.read_text() + "// an edit\n")
    assert lib._key() != key
