"""The port's AST lint (``repro_torch.analysis.lint``), on the CPU: each
rule catches a violation planted in a file of a scratch tree, honours
its suppression and its allowed files, and the repository itself is
clean against an empty baseline.  Where the JAX package's lint
(``repro.analysis.lint``) has the same rule, the two flag the same
planted line."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as jlint                  # noqa: E402

from repro_torch.analysis import __main__ as analysis_cli  # noqa: E402
from repro_torch.analysis import lint                      # noqa: E402

PLANTED = {
    "accepted-kwarg-not-forwarded": (
        "def conv(x, kernel, precision=None):\n    return x @ kernel\n"),
    "raw-environ-read-outside-compat": (
        "import os\nPATH = os.environ.get('REPRO_TORCH_PLAN_CACHE_DIR')\n"),
    "raw-environ-read-outside-compat#getenv": (
        "import os\nPATH = os.getenv('HOME')\n"),
    "raw-environ-read-outside-compat#subscript": (
        "import os\nPATH = os.environ['HOME']\n"),
    "no-reference-import": "import jax\n",
    "no-reference-import#from-jax": "from jax import numpy as jnp\n",
    "no-reference-import#repro": "import repro.core\n",
    "no-reference-import#from-repro": "from repro.core import conv2d\n",
    "no-reference-import#jaxlib": "import jaxlib\n",
}
CLEAN = ("from repro_torch.core import conv2d\nimport os\n"
         "os.environ['X'] = '1'\n"
         "def stub(a, b):\n    raise NotImplementedError\n"
         "def uses(a, _b):\n    return a\n")


def _tree(tmp_path, files):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return lint.lint_tree(tmp_path)


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_each_rule_catches_a_planted_violation(tmp_path, case):
    rule = case.split("#")[0]
    source = PLANTED[case]
    found = _tree(tmp_path, {"src/repro_torch/planted.py": source})
    assert [f.rule for f in found] == [rule]
    assert found[0].path == "src/repro_torch/planted.py"
    assert found[0].key().startswith(f"{rule}:src/repro_torch/planted.py:")
    # a suppression on the flagged line silences it
    lines = source.splitlines()
    lines[found[0].lineno - 1] += f"  # lint-ignore: {rule}"
    assert _tree(tmp_path, {"src/repro_torch/planted.py":
                            "\n".join(lines) + "\n"}) == []
    # the JAX package's lint flags the same line where it has the rule
    if rule in jlint.RULES:
        ref = tmp_path / "ref.py"
        ref.write_text(source)
        jfound = jlint.lint_file(ref, "ref.py")
        assert [f.lineno for f in jfound if f.rule == rule] == \
            [found[0].lineno]


def test_scan_covers_the_script_and_the_tools_and_allowed_files(tmp_path):
    env = "import os\nX = os.environ.get('CUDA_HOME')\n"
    found = _tree(tmp_path, {
        "chip_smoke.py": "import jax\n",
        "tools/probe.py": env,
        "src/repro_torch/kernels/build.py": env,
        "src/repro_torch/plan/cache.py": env,
        "src/repro_torch/plan/calibrate.py": env,
        "src/repro_torch/clean.py": CLEAN,
        "tests/test_x.py": "import jax\n",          # out of scope
    })
    assert sorted((f.path, f.rule) for f in found) == [
        ("chip_smoke.py", "no-reference-import"),
        ("tools/probe.py", "raw-environ-read-outside-compat")]


def test_baseline_grandfathers_and_reports_fixed(tmp_path):
    found = _tree(tmp_path, {"src/repro_torch/a.py": "import jax\n"})
    path = tmp_path / "baseline.json"
    lint.write_baseline(found, path)
    keys = lint.load_baseline(path)
    assert keys == ["no-reference-import:src/repro_torch/a.py:import:jax"]
    split = lint.apply_baseline(found, keys)
    assert split["new"] == [] and len(split["grandfathered"]) == 1
    assert lint.apply_baseline([], keys)["fixed"] == keys
    path.write_text(json.dumps({"lint_baseline_version": 0, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        lint.load_baseline(path)


def test_the_repository_is_clean_against_an_empty_baseline(capsys):
    assert lint.load_baseline(lint.repo_root() / lint.DEFAULT_BASELINE) == []
    assert lint.lint_tree() == []
    assert analysis_cli.main(["--suite", "lint"]) == 0
    assert "lint: clean (0 grandfathered)" in capsys.readouterr().out
