"""A tiny cell for the CPU: the same files' shapes at test size."""

from lutvq_bench.core.spec import Cell

CONFIG = {
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "vocab_size": 256,
    "sliding_window": None, "tie_word_embeddings": False,
    "serving": {
        "architecture": "llama", "max_seq": 128,
        "weights": {"format": "aqlm", "codebooks": 2, "code_bits": 8, "group": 8,
                    "codebook_bytes": 2, "scale_bytes": 2},
        "kv": {"dtype": "int8", "scale": "float32"},
    },
}

MIX = {
    "loop": "closed", "clients": 4, "strata": 4, "horizon": 2,
    "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.8, "min": 4, "max": 48},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.6, "min": 3, "max": 24},
    "batcher": {"n_slots": 4, "strategy": "auto", "attn": "auto", "quality": "exact",
                "prefill_chunk": None},
    "trace": {"after_ticks": 2, "ticks": 3},
}

E2E = [{"name": "output_tok_s", "unit": "tokens/s"}, {"name": "setup_s", "unit": "s"}]
PER_LAYER = [{"name": n, "unit": "ms"} for n in
             ("request_tpot_p95_ms", "request_ttft_p95_ms", "itl_p95_ms", "decode_step_ms")]


def cell(max_gap: float = 1.0, requests: int = 4) -> Cell:
    return Cell("tiny", 1, CONFIG, MIX, {"requests": requests, "max_gap": max_gap}, E2E, PER_LAYER)
