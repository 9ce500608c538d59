"""The import guard: a --trace 0 run of every cell at a tiny size loads no
module whose top-level name is jax, jaxlib, flax or asr_finetune_tpu (the
port's name begins with the JAX package's, so names are compared whole),
and the reference loads nothing of the port. Each in a fresh interpreter."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as RUN

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _fresh(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    got = _fresh(
        "import json, sys\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "from portbench import run as RUN\n"
        f"line = RUN.run_cell(tiny_cell({cell!r}), 2147483659, 0.5, False, device='cpu')\n"
        "print(json.dumps({'bad': RUN.loaded_forbidden(), 'attempted': line['attempted'],\n"
        "                  'port': 'asr_finetune_tpu_torch' in sys.modules}))\n")
    assert got["bad"] == [], got
    assert got["port"] and got["attempted"] > 0


def test_the_reference_loads_nothing_of_the_port():
    mods = [m[:-3] for m in os.listdir(os.path.join(ROOT, "portbench"))
            if m.startswith("reference") and m.endswith(".py")]
    assert mods
    got = _fresh(
        "import json, sys\n"
        + "".join(f"import portbench.{m}\n" for m in mods)
        + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "asr_finetune_tpu_torch" not in got
    assert not set(got) & set(RUN.FORBIDDEN)
