"""rtlint over the port: ``ray_tpu_torch/`` lints clean, as
``tests/test_rtlint.py::test_full_tree_is_clean`` holds ``ray_tpu/`` and
``tools/``. The knob rule (R004) reads the port's own
``ray_tpu_torch/_private/config.py``, found from the tree root."""

import os

from tools.rtlint import find_config_py, format_finding, lint_paths

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "ray_tpu_torch")


def test_port_tree_is_clean():
    assert find_config_py([_PORT]) == os.path.join(_PORT, "_private",
                                                   "config.py")
    findings = lint_paths([_PORT])
    assert findings == [], "\n".join(format_finding(f) for f in findings)
