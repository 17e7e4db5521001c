"""cednerf_torch.ops.cuda_build names each library after its source and the
csrc/ headers, so that an edited header rebuilds the sources that include
it. CPU only: nothing is compiled."""

import os
import re

from cednerf_torch.ops import cuda_build as cb


def _library(stem, source):
    lib = object.__new__(cb.KernelLibrary)   # not registered for build_all
    lib.stem, lib.source = stem, source
    return lib


def test_target_follows_source_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cb, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    lib = _library("k", str(tmp_path / "k.cu"))
    first = lib._target()
    assert first == lib._target()
    assert os.path.basename(first).startswith("libk_")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = lib._target()
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert lib._target() != second


def test_included_headers_are_in_csrc():
    headers = {os.path.basename(h) for h in cb._headers()}
    for name in os.listdir(cb.CSRC_DIR):
        if name.endswith(".cu"):
            with open(os.path.join(cb.CSRC_DIR, name)) as fh:
                for inc in re.findall(r'#include "([^"]+)"', fh.read()):
                    assert inc in headers, (name, inc)
    assert "zline.cuh" in headers


def test_one_registered_library_per_source():
    """build_all() builds every csrc/*.cu once: the kernel modules register
    one library per source, and no source twice."""
    from cednerf_torch.ops import (compact_kernels, encode_kernels,  # noqa
                                   gather_kernels, scatter_kernels)

    stems = [lib.stem for lib in cb.LIBRARIES]
    sources = {n[:-3] for n in os.listdir(cb.CSRC_DIR) if n.endswith(".cu")}
    assert len(stems) == len(set(stems))
    assert set(stems) == sources
