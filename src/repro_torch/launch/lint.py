"""Launcher wiring for the static auditor: ``python -m
repro_torch.launch.lint`` is ``python -m repro_torch.analysis`` (same
flags, same ``LINT_report_torch.json``), kept beside ``dryrun`` and
``train`` so the launch surface lists every entry point in one place.
"""
from __future__ import annotations

import sys

from repro_torch.analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
