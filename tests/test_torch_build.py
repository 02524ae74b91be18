"""The kernel build's cache key: a library is rebuilt when its source or a
shared header changes, and only then. No nvcc needed: only the paths are
computed."""

import os
import re
import shutil

import pytest

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

NAMES = sorted(_build.SIGNATURES)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of ``csrc/`` that the build reads instead."""
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, d)
    monkeypatch.setattr(_build, "CSRC_DIR", str(d))
    return d


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_every_library_has_a_source_and_a_header_exists(csrc):
    for name in NAMES:
        assert os.path.exists(csrc / f"{name}.cu")
    assert os.path.exists(csrc / "sgemm_tile.cuh")


@pytest.mark.parametrize("name", NAMES)
def test_header_edit_changes_every_library_path(csrc, name):
    before = _build.library_path(name)
    _append(csrc / "sgemm_tile.cuh", "\n// edited\n")
    after = _build.library_path(name)
    assert after != before and os.path.dirname(after) == os.path.dirname(before)
    assert os.path.basename(after).startswith(f"{name}-") and after.endswith(".so")


@pytest.mark.parametrize("name", NAMES)
def test_own_source_edit_changes_library_path(csrc, name):
    before = _build.library_path(name)
    _append(csrc / f"{name}.cu", "\n// edited\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", NAMES)
def test_unrelated_edit_keeps_library_path(csrc, name):
    before = _build.library_path(name)
    other = next(n for n in NAMES if n != name)
    _append(csrc / f"{other}.cu", "\n// edited\n")
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build.library_path(name) == before


def test_new_header_changes_library_path(csrc):
    before = _build.library_path("score_topk")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("score_topk") != before


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", NAMES)
def test_signatures_match_the_c_entries(name):
    """Each ctypes signature has as many arguments as its C entry: a
    parameter added to a kernel's entry and not to the wrapper's call shows
    here, not as a crash on the card."""
    src = _source(name)
    for fn, argtypes in _build.SIGNATURES[name].items():
        params = re.search(rf"\bint {fn}\(([^)]*)\)", src).group(1)
        assert len(params.split(",")) == len(argtypes), fn


@pytest.mark.parametrize("name", NAMES)
def test_signature_types_match_the_c_entries(name):
    """Each ctypes argument has its C parameter's kind: a pointer
    (``c_void_p``, or ctypes would cut it to 32 bits) or an ``int``, in
    order."""
    src = _source(name)
    for fn, argtypes in _build.SIGNATURES[name].items():
        params = re.search(rf"\bint {fn}\(([^)]*)\)", src).group(1).split(",")
        kinds = [_build._P if "*" in p else _build._I if p.split()[0] == "int" else None
                 for p in params]
        assert kinds == list(argtypes), fn


def test_netvlad_forward_signature():
    """netvlad_forward: five inputs, the scratch in the order of the
    wrapper's plan, out, six ints, the stream and the preL2 flag, as the
    wrapper passes them."""
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.netvlad import _plan

    params = re.search(r"\bint netvlad_forward\(([^)]*)\)", _source("netvlad")).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    scratch = list(_plan(1, 1, 32, 1)["scratch"])
    assert names == ["x", "w", "bias", "centroids", "sizes", *scratch, "out", "B", "N", "W",
                     "C", "K", "n_chunks", "stream", "pre_l2"]
    assert _build.SIGNATURES["netvlad"]["netvlad_forward"] == (_build._P,) * (6 + len(
        scratch)) + (_build._I,) * 6 + (_build._P, _build._I)
