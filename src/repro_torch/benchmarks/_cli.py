"""The drivers' shared command line: ``--format`` and ``--device``."""
from __future__ import annotations

import argparse


def parse(doc: str, argv=None, **extra):
    """``--format csv|json``, ``--device cuda|cpu`` (the card by default)
    and the driver's ``extra`` options (name -> argparse keywords)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--format", choices=("csv", "json"), default="csv")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for name, kw in extra.items():
        ap.add_argument(f"--{name}", **kw)
    return ap.parse_args(argv)
