"""Serving and demo CLI (counterpart of ``tpu_lutvq.cli``).

    python -m tpu_lutvq_torch.cli generate --ckpt model.lutvq.safetensors --tokens 1,2,3
    python -m tpu_lutvq_torch.cli generate --aqlm <hf_dir> --model 7b --tokens 1,2,3
    python -m tpu_lutvq_torch.cli quantize --out model.lutvq.safetensors --model tiny
    python -m tpu_lutvq_torch.cli report --model 7b --batch 1

Token ids in, token ids out: the prompt is ``--tokens``.  ``--prompt`` and
``--tokenizer`` (the reference's text path, through ``transformers``) are
refused, as the card's machine has no ``transformers``.  ``generate`` and
``quantize`` run on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse

import torch

PRESETS = ("tiny", "7b", "13b", "70b")


def _preset(name: str):
    from tpu_lutvq_torch.models.llama import LlamaConfig

    return {"tiny": LlamaConfig.tiny, "7b": LlamaConfig.llama2_7b,
            "13b": LlamaConfig.llama2_13b, "70b": LlamaConfig.llama2_70b}[name]()


def _parse_tokens(s: str) -> list[int]:
    return [int(t) for t in s.replace(" ", "").split(",") if t]


def cmd_generate(args) -> None:
    from tpu_lutvq_torch.runtime.checkpoint import load_aqlm_llama, load_lutvq
    from tpu_lutvq_torch.runtime.generate import generate

    if args.ckpt:
        cfg, weights = load_lutvq(args.ckpt, device=args.device)
    else:
        cfg = _preset(args.model)
        weights = load_aqlm_llama(args.aqlm, cfg, one_x16=args.one_x16, device=args.device)
    ids = _parse_tokens(args.tokens or "1")
    prompt = torch.tensor([ids], dtype=torch.int32)
    res = generate(
        cfg, weights, prompt, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        generator=torch.Generator(args.device).manual_seed(args.seed),
        stacked_kv=args.stacked_kv,
    )
    print(",".join(map(str, res.tokens[0, len(ids):].tolist())))


def cmd_quantize(args) -> None:
    from tpu_lutvq_torch.models.llama import init_llama
    from tpu_lutvq_torch.runtime.checkpoint import save_lutvq

    cfg = _preset(args.model)
    weights = init_llama(cfg, torch.Generator(args.device).manual_seed(args.seed),
                         dtype=torch.float32)
    save_lutvq(args.out, cfg, weights)
    print(f"wrote {args.out}")


def cmd_report(args) -> None:
    from tpu_lutvq_torch.utils.profiling import print_layer_report

    print_layer_report(_preset(args.model), batch=args.batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu_lutvq_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="decode from a checkpoint")
    g.add_argument("--ckpt", help="native .lutvq.safetensors checkpoint")
    g.add_argument("--aqlm", help="HF AQLM checkpoint dir/file")
    g.add_argument("--model", default="7b", choices=["7b", "13b", "70b"])
    g.add_argument("--tokens", help="comma-separated prompt token ids")
    g.add_argument("--prompt", help="text prompt (refused: no tokenizer here; use --tokens)")
    g.add_argument("--tokenizer", help="HF tokenizer path (refused: use --tokens)")
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling mass in (0, 1); 0 disables")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--stacked-kv", action="store_true",
                   help="serve one stacked (L, ...) KV cache (the hybrid container; a "
                        "stacked checkpoint runs the scan mode)")
    g.add_argument(
        "--one-x16", dest="one_x16", default="dequant",
        choices=["dequant", "chunked", "refit"],
        help="1x16 checkpoints: exact load-time dequant (dense bf16), the codes "
             "kept on the card and rebuilt in chunks, or a 2x8 re-fit served fused",
    )
    g.add_argument("--device", default="cuda")
    g.set_defaults(fn=cmd_generate)

    q = sub.add_parser("quantize", help="write a (synthetic) native checkpoint")
    q.add_argument("--out", required=True)
    q.add_argument("--model", default="tiny", choices=PRESETS)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--device", default="cuda")
    q.set_defaults(fn=cmd_quantize)

    r = sub.add_parser("report", help="analytical per-layer roofline report on the H100")
    r.add_argument("--model", default="7b", choices=PRESETS)
    r.add_argument("--batch", type=int, default=1)
    r.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    if args.cmd == "generate":
        if args.prompt or args.tokenizer:
            ap.error("--prompt/--tokenizer need the transformers tokenizer, which this "
                     "package does not use; pass token ids with --tokens")
        if not args.ckpt and not args.aqlm:
            ap.error("provide --ckpt or --aqlm")
    args.fn(args)


if __name__ == "__main__":
    main()
