"""Quickstart: load a model package and translate.

With a real Bergamot package (from translateLocally / OPUS):

    python examples/quickstart.py --root /path/to/ende.student.tiny11

Without one, generate an offline demo package first:

    python -m slimt_jax synth --out /tmp/demo
    python examples/quickstart.py --root /tmp/demo
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slimt_jax import Blocking, Config, Model, Package, preset
from slimt_jax.runtime.response import Options


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    args = parser.parse_args()

    join = lambda name: os.path.join(args.root, name)
    shortlist = join("shortlist.bin")
    package = Package(
        model=join("model.bin"),
        vocabulary=join("vocab.spm"),
        shortlist=shortlist if os.path.exists(shortlist) else None,
    )

    model = Model(preset.tiny(), package)
    service = Blocking(Config())

    sources = [
        "Hello world. How are you today?",
        "The quick brown fox jumps over the lazy dog.",
    ]
    responses = service.translate(model, sources, Options(alignment=True))
    for response in responses:
        print(f"source: {response.source.text!r}")
        print(f"target: {response.target.text!r}")
        for s in range(response.source.sentence_count()):
            print(f"  sentence {s}: {response.source.sentence(s)!r} -> "
                  f"{response.target.sentence(s)!r}")
        print()


if __name__ == "__main__":
    main()
