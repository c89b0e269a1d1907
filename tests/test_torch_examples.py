"""The port's three single-device examples, each run as a subprocess on the
CPU (``--device cpu``) at a tiny size: exit 0, every record it consumed
committed (the committed offsets equal the topic's end offsets), and no
module of JAX or of the JAX package loaded. The CTR example also trains as
a two-process pod, and the serving example serves on a two-rank tp mesh."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

CASES = {
    "train_stream_torch.py": ["--steps", "3", "--batch", "4", "--records", "12",
                              "--ckpt-every", "2"],
    "serve_prompts_torch.py": ["--prompts", "6", "--slots", "2", "--max-new", "4"],
    "ctr_train_torch.py": ["--steps", "3", "--batch", "16"],
}
_NO_JAX = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'torchkafka_tpu'))\n"
    "    print('JAX_MODULES', bad)\n"
)


def _run(name, args, tmp_path):
    extra = ["--ckpt", str(tmp_path / "ckpt")] if name.startswith("train") else []
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT / "examples" / name), *args, *extra,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_commits_every_record(name, tmp_path):
    proc = _run(name, CASES[name], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = re.search(r"^offsets: committed=(\d+) end=(\d+)", proc.stdout, re.M)
    assert line, proc.stdout[-2000:]
    committed, end = int(line.group(1)), int(line.group(2))
    assert committed == end > 0
    assert "JAX_MODULES []" in proc.stdout


def test_serve_example_on_a_tp_mesh(tmp_path):
    """``--tp 2``: two gloo ranks on {"tp": 2}; rank 0 alone owns the
    broker, commits every prompt and publishes every completion, and both
    ranks serve the same tokens."""
    proc = _run("serve_prompts_torch.py", ["--tp", "2", "--prompts", "6", "--slots", "2",
                                           "--max-new", "4"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = dict(re.findall(r"^rank (\d): served (\d+) tokens", proc.stdout, re.M))
    assert served == {"0": "24", "1": "24"}, proc.stdout[-2000:]
    line = re.search(r"^rank 0: .*offsets: committed=(\d+) end=(\d+) published=(\d+)",
                     proc.stdout, re.M)
    assert line and line.group(1) == line.group(2) == line.group(3) == "6"
    assert "pod of 2 processes completed cleanly" in proc.stdout
    assert "JAX_MODULES []" in proc.stdout


def test_cpu_devices_flag_names_the_process_mesh(monkeypatch):
    """In this process: the JAX example's ``--cpu-devices`` (virtual XLA
    devices) has no counterpart; it is refused, pointing at ``--tp``,
    before any model is built."""
    import runpy

    name = "serve_prompts_torch.py"
    main = runpy.run_path(str(ROOT / "examples" / name), run_name="example")["main"]
    monkeypatch.setattr(sys, "argv", [name, "--cpu-devices", "8", "--device", "cpu"])
    with pytest.raises(ValueError, match="--tp N"):
        main()


def test_ctr_example_trains_on_two_processes(tmp_path):
    """``--processes 2``: two gloo ranks on {"data": 1, "tp": 2} (the
    tables row-sharded over tp); both tp ranks read the same partitions,
    and each commits exactly the records it trained, its partitions' end."""
    steps, batch = 3, 16
    proc = _run("ctr_train_torch.py", ["--processes", "2", "--steps", str(steps),
                                        "--batch", str(batch)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh {'data': 1, 'tp': 2}" in proc.stdout
    lines = re.findall(r"^rank (\d): trained=(\d+) offsets: committed=(\d+) end=(\d+)",
                       proc.stdout, re.M)
    assert sorted(int(r) for r, *_ in lines) == [0, 1], proc.stdout[-2000:]
    for _, trained, committed, end in lines:
        assert int(trained) == int(committed) == int(end) == steps * batch
    assert "pod of 2 processes completed cleanly" in proc.stdout
    assert "JAX_MODULES []" in proc.stdout
