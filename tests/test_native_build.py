"""utils/native.py: finding a C++ compiler and building a helper once."""

import os
import stat

from hijiki.utils import native


def _fake_exe(path):
    path.write_text("#!/bin/sh\nexit 1\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def test_find_cxx_prefers_cxx_env(monkeypatch, tmp_path):
    exe = tmp_path / "mycxx"
    _fake_exe(exe)
    monkeypatch.setenv("CXX", str(exe))
    assert native.find_cxx() == str(exe)


def test_find_cxx_takes_a_target_prefixed_gxx(monkeypatch, tmp_path):
    """Machines that ship only a versioned, target-prefixed compiler
    (x86_64-linux-gnu-g++-13) still build the helpers."""
    exe = tmp_path / "x86_64-linux-gnu-g++-13"
    _fake_exe(exe)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.find_cxx() == str(exe)


def test_shared_object_builds_once_and_reports_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(native.tempfile, "gettempdir", lambda: str(tmp_path))
    src = tmp_path / "ok.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    so = native.shared_object(str(src), "ok", ["-O1"])
    mtime = os.path.getmtime(so)
    assert native.shared_object(str(src), "ok", ["-O1"]) == so
    assert os.path.getmtime(so) == mtime  # cached, not rebuilt
    import ctypes

    assert ctypes.CDLL(so).answer() == 42
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    try:
        native.shared_object(str(bad), "bad", [])
    except RuntimeError as e:
        assert "bad.cpp" in str(e)
    else:
        raise AssertionError("a failed build must raise")
