"""Schema-validate telemetry event streams (the CI gate; a copy of the
pure-Python ``repro/telemetry/validate.py``: the same verdicts and lines).

    python -m repro_torch.telemetry.validate events.jsonl [more.jsonl ...]

Exit 0 iff every file parses, every record matches its
:data:`repro_torch.telemetry.events.EVENT_SCHEMAS` entry (unknown types,
missing required fields and UNKNOWN fields all fail), seq is gapless
from 0, and round events are contiguous. Prints a per-file verdict and
the first errors."""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.telemetry.events import read_events, validate_stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate telemetry events JSONL files")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--max-errors", type=int, default=10,
                    help="errors printed per file")
    args = ap.parse_args(argv)

    failed = False
    for path in args.paths:
        try:
            errors = validate_stream(path)
            n = len(read_events(path))
        except OSError as e:
            print(f"{path}: UNREADABLE ({e})")
            failed = True
            continue
        if errors:
            failed = True
            print(f"{path}: INVALID ({len(errors)} errors over {n} events)")
            for e in errors[:args.max_errors]:
                print(f"  - {e}")
            if len(errors) > args.max_errors:
                print(f"  ... {len(errors) - args.max_errors} more")
        else:
            print(f"{path}: ok ({n} events)")
    print(json.dumps({"ok": not failed, "files": len(args.paths)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
