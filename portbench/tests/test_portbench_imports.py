"""What the harness loads: no JAX, and a reference apart from the
program; and no result without a card."""
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "facerec_tpu"}


def _top_level_modules(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    process (compared whole: ``facerec_torch`` is not ``facerec_tpu``)."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted(" \
        "{m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = _top_level_modules(
        "import portbench.run, portbench.film, portbench.compare, "
        "portbench.probe, portbench.trace, portbench.counts, "
        "portbench.weights, portbench.reference.pipeline, "
        "portbench.embedders.facenet\n"
        "import facerec_torch.pipeline.extract, facerec_torch.config, "
        "facerec_torch.models.facenet, facerec_torch.runtime.launches")
    assert "facerec_torch" in mods and "portbench" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "import portbench.reference.pipeline, portbench.reference.nets, "
        "portbench.reference.detect, portbench.reference.scene, "
        "portbench.reference.track, portbench.reference.embed, "
        "portbench.compare, portbench.counts, portbench.weights, "
        "portbench.probe, portbench.embedders.facenet\n"
        "import torch, portbench.run as r\n"
        "fam, cpu = r.embedder_family({}), torch.device('cpu')\n"
        "ref = fam.reference(fam.states({'facenets': {'a': 128}}, 0, cpu), "
        "cpu)\n"
        "ref(torch.zeros(1, 96, 128, 3, dtype=torch.uint8), [{'frame': 0, "
        "'box': [30, 20, 70, 68], 'landmarks': torch.zeros(5, 2)}])")
    assert "facerec_torch" not in mods
    assert not mods & FORBIDDEN


def _no_result(cwd):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "pal576-dialogue", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert not line.startswith("{")


def test_no_result_without_a_card():
    _no_result(REPO)


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path)
