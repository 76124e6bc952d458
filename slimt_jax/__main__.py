import os
import sys

from slimt_jax.cli import main

# The __name__ guard matters: ingest worker processes are spawned, and
# spawn re-imports the parent's __main__ module (as "__mp_main__") —
# without the guard every worker would re-run the CLI.
if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout consumer (head, less, …) closed early — not an error.
        # Point fd 1 at /dev/null so the interpreter's exit-time stdout
        # flush cannot raise again; safe here because the process is
        # exiting (cli.main itself stays side-effect-free for
        # in-process callers).
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
