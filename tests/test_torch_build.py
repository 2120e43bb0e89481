"""kernels/build.py against a stand-in for nvcc: one compile process per
source, all running at once, one link of their objects, a failing source
named in the error. Runs without the CUDA toolkit."""

import os
import stat
import sys
import textwrap

import pytest

from kmerlsh_tpu_torch.kernels import build

# Compiles wait until every source's compile has started, so a build that
# ran them one at a time would time out and fail.
FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    log = {log!r}
    if "-shared" in args:
        objs = [a for a in args if a.endswith(".o")]
        with open(log, "a") as f:
            f.write("link " + " ".join(os.path.basename(o) for o in objs) + "\\n")
        with open(out, "w") as f:
            f.write("".join(open(o).read() for o in objs))
        sys.exit(0)
    src = args[-1]
    with open(log, "a") as f:
        f.write("compile " + os.path.basename(src) + "\\n")
    os.makedirs({started!r}, exist_ok=True)
    open(os.path.join({started!r}, os.path.basename(src)), "w").close()
    deadline = time.time() + 30
    while len(os.listdir({started!r})) < {n} and time.time() < deadline:
        time.sleep(0.01)
    if len(os.listdir({started!r})) < {n}:
        sys.exit("compiles did not run together")
    if "#error" in open(src).read():
        sys.exit(src + ": error: planted")
    with open(out, "w") as f:
        f.write(os.path.basename(src) + "\\n")
    """)


@pytest.fixture
def fake(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()

    def make(sources: dict[str, str]):
        for name, text in sources.items():
            (csrc / name).write_text(text)
        nvcc = tmp_path / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(
            python=sys.executable, log=str(tmp_path / "log"),
            started=str(tmp_path / "started"), n=len(sources)))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
        monkeypatch.setattr(build, "CSRC", csrc)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
        return tmp_path / "log"

    return make


def test_build_compiles_sources_together_and_links(fake):
    log = fake({f"k{i}.cu": f"// kernel {i}\n" for i in range(4)})
    lib = build.build()
    assert lib == build.library_path() and lib.exists()
    assert sorted(lib.read_text().split()) == [f"k{i}.cu" for i in range(4)]
    lines = log.read_text().splitlines()
    assert sorted(x for x in lines if x.startswith("compile")) == [
        f"compile k{i}.cu" for i in range(4)]
    assert lines[-1] == "link " + " ".join(f"k{i}.o" for i in range(4))
    assert os.listdir(lib.parent) == [lib.name]       # no objects left
    build.build()                                     # built: no new run
    assert log.read_text().splitlines() == lines


def test_build_names_the_failing_source(fake):
    fake({"good.cu": "// fine\n", "bad.cu": "#error planted\n"})
    with pytest.raises(RuntimeError, match=r"nvcc failed: bad\.cu"):
        build.build()
    assert not build.library_path().exists()
    assert os.listdir(build.BUILD_DIR) == []
