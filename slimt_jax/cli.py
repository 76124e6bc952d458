"""Command-line interface.

Mirrors the reference CLI surfaces:
  - `slimt-cli` flags --root/--model/--vocabulary/--shortlist/--html/
    --async/--workers/--poll, reads stdin, prints translations
    (app/main.cc:25-185), pivot via --follow-* second model;
  - the python package's `slimt {translate,ls,download}` subcommands
    (bindings/python/cmds.py): `download`/`ls` ride the repository
    inventory layer (slimt_jax/repository.py) and degrade gracefully
    offline (archives placed in the cache dir unpack without network);
    `synth` generates a synthetic demo package for air-gapped use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_model_args(parser, prefix=""):
    flag = lambda name: f"--{prefix}{name}"
    # follow-* (pivot second model) defaults stay None so pivot only
    # engages when explicitly requested (app/main.cc --follow-* flags).
    default = (lambda v: v) if not prefix else (lambda v: None)
    parser.add_argument(flag("root"), default=default(""), help="artifact dir")
    parser.add_argument(flag("model"), default=default("model.bin"))
    parser.add_argument(flag("vocabulary"), default=default("vocab.spm"))
    parser.add_argument(flag("shortlist"), default=None)
    parser.add_argument(flag("ssplit"), default=None)


def _package(args, prefix=""):
    from slimt_jax.models.model import Package

    get = lambda name: getattr(args, (prefix + name).replace("-", "_"))
    root = get("root")
    join = lambda p: os.path.join(root, p) if root else p
    return Package(
        model=join(get("model")),
        vocabulary=join(get("vocabulary")),
        shortlist=join(get("shortlist")) if get("shortlist") else None,
        ssplit=join(get("ssplit")) if get("ssplit") else None,
    )


def _remote_translate(args) -> int:
    """Thin fleet client: the same CLI against a slimt_jax.server (or
    runtime.router) endpoint instead of local chips. --async polls the
    /submit + /job/<id> API and renders the same progress meter the
    local path renders from Handle::info."""
    import urllib.error
    import urllib.request

    def call(path, payload):
        request = urllib.request.Request(
            args.url.rstrip("/") + path,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(request, timeout=600) as resp:
            return json.loads(resp.read())

    def get(path):
        with urllib.request.urlopen(
            args.url.rstrip("/") + path, timeout=60
        ) as resp:
            return json.loads(resp.read())

    text = sys.stdin.read() if args.text is None else args.text
    payload = {"text": text, "html": args.html}
    if args.remote_model:
        payload["model"] = args.remote_model
    if args.remote_pivot:
        payload["pivot"] = args.remote_pivot
    try:
        if args.use_async:
            job = call("/submit", payload)["job"]
            while True:
                body = get(f"/job/{job}")
                if body["done"]:
                    break
                if args.poll:
                    p = body["progress"]
                    wp, wq = p["words"]
                    print(
                        f"\r[{p['parts'][0]}/{p['parts'][1]}] "
                        f"{100.0 * wp / wq if wq else 100.0:5.1f}% words "
                        f"({p['wps']:8.1f} wps)",
                        end="",
                        file=sys.stderr,
                    )
                time.sleep(args.poll or 0.1)
            if args.poll:
                print(file=sys.stderr)
            if body.get("error"):
                print(f"remote error: {body['error']}", file=sys.stderr)
                return 1
        else:
            body = call("/translate", payload)
        print(body["target"])
        return 0
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read()).get("error", "")
        except Exception:  # noqa: BLE001
            detail = ""
        print(f"server returned {e.code}: {detail}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 1


def cmd_translate(args) -> int:
    if args.url:
        return _remote_translate(args)
    from slimt_jax.config import Config, preset
    from slimt_jax.models.model import Model
    from slimt_jax.runtime.response import Options
    from slimt_jax.runtime.service import Async, Blocking

    config = Config(
        max_words=args.max_words,
        cache_size=args.cache_size,
        workers=args.workers,
        wrap_length=args.wrap_length,
        tgt_length_limit_factor=args.limit_factor,
    )
    import dataclasses

    model_config = getattr(preset, args.preset)()
    follow_config = dataclasses.replace(model_config)
    # Per-model architecture overrides (reference Model::Config
    # setup_onto flags, slimt/Model.hh:33-51).
    if args.encoder_layers:
        model_config.encoder_layers = args.encoder_layers
    if args.decoder_layers:
        model_config.decoder_layers = args.decoder_layers
    if args.num_heads:
        model_config.num_heads = args.num_heads
    if args.split_mode:
        model_config.split_mode = args.split_mode
    # Execution-numerics overrides (engine extensions; no reference
    # counterpart). --exact pins the reference-exact path — what the
    # crosscheck e2e differential uses for byte-identical comparison.
    if args.exact and (args.kv_dtype or args.argmax_method):
        # --exact promises the reference-exact numerics; silently
        # letting a later flag un-pin them would make the flag lie.
        print(
            "--exact pins kv-dtype/argmax-method; do not combine it "
            "with --kv-dtype or --argmax-method",
            file=sys.stderr,
        )
        return 2
    if args.exact:
        model_config.kv_cache_dtype = "float32"
        model_config.argmax_method = "exact"
    if args.kv_dtype:
        model_config.kv_cache_dtype = args.kv_dtype
    if args.argmax_method:
        model_config.argmax_method = args.argmax_method
    # The pivot's second model shares the numerics choice.
    follow_config.kv_cache_dtype = model_config.kv_cache_dtype
    follow_config.argmax_method = model_config.argmax_method
    model = Model(
        model_config, _package(args),
        tgt_length_limit_factor=args.limit_factor,
    )
    follow = None
    if args.follow_model and args.follow_vocabulary:
        # follow model keeps preset architecture; the per-model
        # override flags apply to the primary only
        follow = Model(
            follow_config, _package(args, "follow-"),
            tgt_length_limit_factor=args.limit_factor,
        )

    options = Options(html=args.html, alignment=args.html or args.alignment)
    text = sys.stdin.read() if args.text is None else args.text

    if args.use_async:
        with Async(config) as service:
            if follow is not None:
                handle = service.pivot(model, follow, text, options)
            else:
                handle = service.translate(model, text, options)
            if args.poll:
                while not handle.future.done():
                    info = handle.info()
                    print(
                        f"\r[{info.parts.p}/{info.parts.q}] "
                        f"{info.words.percent():5.1f}% words "
                        f"({info.wps:8.1f} wps)",
                        end="",
                        file=sys.stderr,
                    )
                    time.sleep(args.poll)
                print(file=sys.stderr)
            response = handle.result()
    else:
        service = Blocking(config)
        if follow is not None:
            response = service.pivot(model, follow, [text], options)[0]
        else:
            # bulk: same Responses as translate(), ~2x host throughput
            response = service.translate_bulk(model, [text], options)[0]
    print(response.target.text)
    return 0


def cmd_synth(args) -> int:
    """Generate a synthetic demo package into --out."""
    from slimt_jax.config import preset
    from slimt_jax.io.shortlist import build_synthetic_shortlist
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    os.makedirs(args.out, exist_ok=True)
    config = getattr(preset, args.preset)()
    spm = build_spm_model(DEFAULT_WORDS)
    vocab_size = max(len(spm.pieces), 64)
    spm = build_spm_model(DEFAULT_WORDS, target_size=vocab_size)
    with open(os.path.join(args.out, "model.bin"), "wb") as f:
        f.write(
            synthetic_model_bytes(
                config=config,
                vocab_size=vocab_size,
                emb_dim=args.emb_dim,
                ffn_dim=args.ffn_dim,
            )
        )
    with open(os.path.join(args.out, "vocab.spm"), "wb") as f:
        f.write(spm_proto.serialize_model(spm))
    with open(os.path.join(args.out, "shortlist.bin"), "wb") as f:
        f.write(build_synthetic_shortlist(vocab_size))
    print(f"synthetic package written to {args.out}")
    return 0


def cmd_convert(args) -> int:
    from slimt_jax.config import preset
    from slimt_jax.io.checkpoint import convert_marian

    with open(args.input, "rb") as f:
        model_bytes = f.read()
    converted = convert_marian(model_bytes, getattr(preset, args.preset)())
    with open(args.output, "wb") as f:
        f.write(converted)
    print(f"wrote {args.output} ({len(converted) / 1e6:.1f} MB)")
    return 0


def cmd_inspect(args) -> int:
    """Print the tensor table of a marian .bin model (name, marian
    type, shape, quantization scale) — the reference's
    scripts/inspect-bin.py / marian-file-inspect.py workflow. Also
    reads native .npz checkpoints."""
    if args.input.endswith(".npz"):
        import numpy as np

        with np.load(args.input) as z:
            total = 0
            for name in z.files:
                arr = z[name]
                total += arr.nbytes
                print(
                    f"{name:<44s} {str(arr.dtype):<8s} "
                    f"{'x'.join(map(str, arr.shape))}"
                )
            print(f"{len(z.files)} arrays, {total / 1e6:.1f} MB")
        return 0

    from slimt_jax.io.marian import TYPE_NAMES, load_items

    items = load_items(args.input)
    total = 0
    for item in items:
        total += item.array.nbytes
        scale = f" scale={item.scale:.6g}" if item.scale is not None else ""
        type_name = TYPE_NAMES.get(item.type_code, hex(item.type_code))
        print(
            f"{item.name:<44s} {type_name:<10s} "
            f"{'x'.join(map(str, item.shape)):<14s}{scale}"
        )
    print(f"{len(items)} tensors, {total / 1e6:.1f} MB payload")
    return 0


def _repository(args):
    """Resolve the chosen inventory (reference cmds.py defaults to
    browsermt; bindings/python/repository.py:124-139). --repo-root
    redirects the XDG dirs (tests / air-gapped mirrors)."""
    from slimt_jax.repository import TranslateLocallyLike, default_repositories

    if getattr(args, "repo_root", None):
        urls = {
            "browsermt": "https://translatelocally.com/models.json",
            "opus": "https://object.pouta.csc.fi/OPUS-MT-models/app/models.json",
        }
        return TranslateLocallyLike(
            args.repository, urls[args.repository], root=args.repo_root
        )
    return default_repositories()[args.repository]


def cmd_ls(args) -> int:
    # Local package-directory listing (slimt_jax-specific) when --root
    # is given; otherwise the reference's inventory listing
    # (bindings/python/cmds.py List.execute).
    if args.root:
        if not os.path.isdir(args.root):
            print(f"no models under {args.root}")
            return 0
        for entry in sorted(os.listdir(args.root)):
            print(entry)
        return 0
    repo = _repository(args)
    codes = repo.models(filter_downloaded=not args.all)
    if not codes:
        where = "available in" if args.all else "downloaded from"
        print(
            f"no models {where} {repo.name!r} "
            f"(inventory: {repo.models_file_path})"
        )
        return 0
    print("Available models: ")
    for counter, identifier in enumerate(codes, 1):
        entry = repo.model(identifier) or {}
        print(
            " {}.".format(str(counter).rjust(4)),
            entry.get("code", identifier),
            entry.get("name", ""),
        )
    print()
    return 0


def cmd_download(args) -> int:
    """Download + unpack model packages from a repository inventory
    (reference bindings/python/cmds.py Download.execute +
    repository.py:53-120). Offline-graceful: an archive already in
    the cache directory unpacks without network; otherwise the error
    names the exact paths to drop files into."""
    repo = _repository(args)
    codes = (
        [args.model]
        if args.model
        else repo.models(filter_downloaded=False)
    )
    if not codes:
        print(
            f"repository {repo.name!r} has an empty inventory "
            f"(offline?). Drop a models.json at {repo.models_file_path} "
            f"or archives under {repo.dirs['archive']}.",
            file=sys.stderr,
        )
        return 1
    failures = 0
    for code in codes:
        try:
            repo.download(code)
            print(f"{code}: ok -> {os.path.join(repo.dirs['models'], code)}")
        except KeyError:
            print(
                f"{code}: unknown model (see `ls --all -r {repo.name}`)",
                file=sys.stderr,
            )
            failures += 1
        except Exception as error:  # URLError, timeout, tar errors...
            entry = repo.model(code) or {}
            archive = os.path.basename(entry.get("url", f"{code}.tar.gz"))
            print(
                f"{code}: download failed ({error}). Offline? Place the "
                f"archive at {os.path.join(repo.dirs['archive'], archive)} "
                "and re-run to unpack from the local cache.",
                file=sys.stderr,
            )
            failures += 1
    return 1 if failures else 0


def main(argv=None) -> int:
    from slimt_jax.device import configure_compile_cache

    configure_compile_cache()
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # serve/route delegate to the server and router mains (their own
    # argparse surfaces); intercepted here so every entry point is
    # reachable from `python -m slimt_jax <cmd>`.
    if argv[:1] == ["serve"]:
        from slimt_jax.server import main as server_main

        return server_main(argv[1:])
    if argv[:1] == ["route"]:
        from slimt_jax.runtime.router import main as router_main

        return router_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="slimt_jax", description="slimt translation engine on JAX"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("serve", help="HTTP serving endpoint (slimt_jax.server)")
    sub.add_parser(
        "route", help="multi-host request router (runtime.router)"
    )

    t = sub.add_parser("translate", help="translate stdin or --text")
    _add_model_args(t)
    _add_model_args(t, "follow-")
    t.add_argument("--preset", default="tiny", choices=["tiny", "base", "nano"])
    t.add_argument("--text", default=None)
    t.add_argument("--html", action="store_true")
    t.add_argument("--alignment", action="store_true")
    t.add_argument("--async", dest="use_async", action="store_true")
    t.add_argument("--workers", type=int, default=1)
    t.add_argument("--poll", type=float, default=0.0)
    t.add_argument("--max-words", type=int, default=1024)
    t.add_argument("--cache-size", type=int, default=1024)
    t.add_argument("--wrap-length", type=int, default=128)
    t.add_argument("--limit-factor", type=float, default=1.5)
    t.add_argument("--encoder-layers", type=int, default=0)
    t.add_argument("--decoder-layers", type=int, default=0)
    t.add_argument("--num-heads", type=int, default=0)
    t.add_argument(
        "--split-mode", default=None,
        choices=["sentence", "paragraph", "wrapped_text"],
    )
    t.add_argument(
        "--exact", action="store_true",
        help="pin reference-exact numerics (f32 KV + exact argmax)",
    )
    t.add_argument(
        "--kv-dtype", default=None,
        choices=["float32", "int16", "k8v16", "k16v8", "float16", "bfloat16",
                 "int8"],
    )
    t.add_argument(
        "--argmax-method", default=None,
        choices=["exact", "packed_int", "packed_fp16", "packed_bf16"],
    )
    t.add_argument(
        "--url", default=None,
        help="translate via a slimt_jax.server / router endpoint "
        "instead of local chips (--async polls /submit + /job)",
    )
    t.add_argument(
        "--remote-model", default=None,
        help="model name in the remote server's registry",
    )
    t.add_argument(
        "--remote-pivot", default=None,
        help="pivot model name in the remote server's registry",
    )
    t.set_defaults(fn=cmd_translate)

    s = sub.add_parser("synth", help="generate a synthetic demo package")
    s.add_argument("--out", default="./synthetic-package")
    s.add_argument("--preset", default="tiny", choices=["tiny", "base", "nano"])
    s.add_argument("--emb-dim", type=int, default=64)
    s.add_argument("--ffn-dim", type=int, default=128)
    s.set_defaults(fn=cmd_synth)

    ls = sub.add_parser(
        "ls", help="list repository models (or local packages with --root)"
    )
    ls.add_argument("--root", default=None)
    ls.add_argument(
        "-r", "--repository", default="browsermt",
        choices=["browsermt", "opus"],
    )
    ls.add_argument(
        "--all", action="store_true",
        help="list the full inventory, not just downloaded models",
    )
    ls.add_argument("--repo-root", default=None, help=argparse.SUPPRESS)
    ls.set_defaults(fn=cmd_ls)

    ins = sub.add_parser(
        "inspect", help="print the tensor table of a .bin / .npz model"
    )
    ins.add_argument("input")
    ins.set_defaults(fn=cmd_inspect)

    d = sub.add_parser(
        "download", help="download + unpack models from a repository"
    )
    d.add_argument(
        "-m", "--model", default=None,
        help="model code to fetch; omitted = every inventory model",
    )
    d.add_argument(
        "-r", "--repository", default="browsermt",
        choices=["browsermt", "opus"],
    )
    d.add_argument("--repo-root", default=None, help=argparse.SUPPRESS)
    d.set_defaults(fn=cmd_download)

    c = sub.add_parser(
        "convert", help="marian .bin → native checkpoint (.npz)"
    )
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--preset", default="tiny", choices=["tiny", "base", "nano"])
    c.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(
            f"error: {e.filename or e}: no such file — check --root/--model/"
            "--vocabulary paths (generate a demo package with `synth`)",
            file=sys.stderr,
        )
        return 1
    except Exception as e:
        from slimt_jax.html.scanner import BadHTML
        from slimt_jax.io.loader import MissingParameter

        if isinstance(e, BadHTML):
            print(f"error: malformed HTML input: {e}", file=sys.stderr)
            return 1
        if isinstance(e, MissingParameter):
            print(
                f"error: model file has no parameter {e} — the "
                "--encoder-layers/--decoder-layers/--preset settings "
                "likely exceed the checkpoint's architecture",
                file=sys.stderr,
            )
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
