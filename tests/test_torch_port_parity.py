"""PORT_PARITY: every CUDA entry point of the port, the Pallas bodies it
stands for, and the tests that hold it to them.

The counterpart of `tests/test_kernel_parity.py:KERNEL_PARITY` for the
PyTorch/CUDA port. Each `extern "C"` entry point in
`llm_mcp_tpu_torch/kernels/csrc/` maps to the `_*_kernel` bodies of
`llm_mcp_tpu/kernels/attention.py` it replaces, its CPU parity test (the
plain version against the Pallas body in interpret mode) and its card test
in `tests/test_torch_cuda.py` (the kernel against its plain version). A
body may stand behind several entry points: the appends' bodies are both
the standalone append entry points and the fused append of the decode
entry points (`append=True`), whose tests are listed beside the decode
ones. The guards read the sources as text, so they need neither a card
nor `nvcc`: a new Pallas body, a new entry point or a renamed test that is
not registered here fails them.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from llm_mcp_tpu_torch.kernels import attention as P

ROOT = Path(__file__).resolve().parent.parent
PALLAS = ROOT / "llm_mcp_tpu" / "kernels" / "attention.py"
CSRC = ROOT / "llm_mcp_tpu_torch" / "kernels" / "csrc"
CARD = "tests/test_torch_cuda.py"
KERNELS = "tests/test_torch_kernels.py"
MLA = "tests/test_torch_mla.py"
FUSED = "tests/test_torch_fused_append.py"
WHOLE_ROW = "tests/test_torch_q8_whole_row.py"
FUSED_CPU = (FUSED, "test_decode_step_fused_append_matches_post_scan_and_jax")
FUSED_CARD = "test_cuda_decode_fused_append"
FAMILY = "tests/test_torch_family_kernels.py"
HD64 = "tests/test_torch_hd64.py"
HD64_DECODE = (HD64, "test_decode_bf16_hd64_matches_pallas_and_appends")
HD64_Q8 = (HD64, "test_decode_q8_hd64_matches_pallas_and_appends")
HD64_ENGINE = (HD64, "test_engine_hd64_greedy_tokens_match_jax")

# entry point: (Pallas bodies, (CPU parity test file, name) or a tuple of
# them, card test name or a tuple of them)
PORT_PARITY = {
    "append_kv_bf16": (
        ("_append_bf16_kernel",), (KERNELS, "test_append_kv_bitwise"),
        "test_cuda_kernels_match_plain"),
    "decode_attend_bf16": (
        ("_attend_bf16_kernel", "_attend_bf16_blocked_kernel", "_append_bf16_kernel"),
        ((KERNELS, "test_decode_attend_matches_pallas"), FUSED_CPU),
        ("test_cuda_decode_bf16_split_edges", FUSED_CARD)),
    "decode_attend_bf16_paged": (
        ("_attend_bf16_paged_kernel", "_append_bf16_kernel"),
        ((KERNELS, "test_decode_attend_paged_matches_pallas"), FUSED_CPU),
        ("test_cuda_decode_bf16_paged_edges", FUSED_CARD,
         "test_cuda_decode_g_not_dividing_64_paged")),
    "decode_attention_bf16": (
        ("_decode_attn_kernel",), (KERNELS, "test_decode_attention_matches_pallas"),
        "test_cuda_decode_attention_split_edges"),
    "flash_prefill_bf16": (
        ("_flash_prefill_kernel",), (KERNELS, "test_flash_prefill_matches_pallas"),
        "test_cuda_flash_prefill_tile_edges"),
    # head_dim 256 (Gemma-2): the same body on the two-warpgroup tile
    "flash_prefill_bf16_hd256": (
        ("_flash_prefill_kernel",), (FAMILY, "test_flash_prefill_hd256_matches_pallas"),
        "test_cuda_flash_prefill_hd256"),
    "ragged_prefill_bf16": (
        ("_ragged_prefill_bf16_kernel",),
        ((KERNELS, "test_ragged_prefill_matches_pallas"),
         (FAMILY, "test_ragged_prefill_g_not_dividing_64_matches_pallas")),
        "test_cuda_ragged_prefill_tile_edges"),
    "ragged_prefill_bf16_paged": (
        ("_ragged_prefill_bf16_kernel",),
        ((KERNELS, "test_ragged_prefill_paged_matches_pallas"),
         (FAMILY, "test_ragged_prefill_g_not_dividing_64_matches_pallas")),
        "test_cuda_ragged_prefill_tile_edges"),
    "append_kv_q8": (
        ("_append_q8_kernel",), (KERNELS, "test_append_kv_q8_bitwise"),
        "test_cuda_q8_kernels_match_plain"),
    "decode_attend_q8": (
        ("_attend_q8_kernel", "_attend_q8_blocked_kernel", "_append_q8_kernel"),
        ((KERNELS, "test_decode_attend_q8_matches_pallas"),
         (WHOLE_ROW, "test_decode_attend_q8_whole_row_matches_jax"), FUSED_CPU),
        ("test_cuda_q8_kernels_match_plain", "test_cuda_q8_decode_whole_row", FUSED_CARD)),
    "decode_attend_q8_paged": (
        ("_attend_q8_paged_kernel", "_append_q8_kernel"),
        ((KERNELS, "test_decode_attend_q8_paged_matches_pallas"), FUSED_CPU),
        ("test_cuda_q8_paged_kernels_match_plain", FUSED_CARD,
         "test_cuda_decode_g_not_dividing_64_paged")),
    "ragged_prefill_q8": (
        ("_ragged_prefill_q8_kernel",),
        ((KERNELS, "test_ragged_prefill_q8_matches_pallas"),
         (FAMILY, "test_ragged_prefill_q8_g_not_dividing_64_matches_pallas")),
        "test_cuda_ragged_prefill_tile_edges"),
    "ragged_prefill_q8_paged": (
        ("_ragged_prefill_q8_kernel",),
        ((KERNELS, "test_ragged_prefill_q8_paged_matches_pallas"),
         (FAMILY, "test_ragged_prefill_q8_g_not_dividing_64_matches_pallas")),
        "test_cuda_ragged_prefill_tile_edges"),
    "decode_attend_q8_mla": (
        ("_attend_q8_mla_kernel", "_attend_q8_mla_blocked_kernel"),
        (MLA, "test_decode_attend_q8_mla_matches_pallas"), "test_cuda_mla_decode_matches_plain"),
    "decode_attend_q8_mla_paged": (
        ("_attend_q8_mla_paged_kernel",), (MLA, "test_decode_attend_q8_mla_paged_matches_pallas"),
        "test_cuda_mla_decode_matches_plain"),
    **{name: (("_ragged_prefill_mla_kernel",),
              (MLA, "test_ragged_prefill_attend_mla_matches_pallas"),
              "test_cuda_mla_ragged_tile_edges")
       for name in ("ragged_prefill_mla", "ragged_prefill_mla_paged", "ragged_prefill_mla_q8",
                    "ragged_prefill_mla_q8_paged")},
    # head_dim 64 (Llama-3.2-1B, Qwen2.5-0.5B): the same bodies, the _hd64
    # libraries
    "flash_prefill_bf16_hd64": (
        ("_flash_prefill_kernel",), ((HD64, "test_flash_prefill_hd64_matches_pallas"),
                                     HD64_ENGINE), "test_cuda_flash_prefill_hd64"),
    **{f"ragged_prefill_{a}_hd64": (
        (f"_ragged_prefill_{a.split('_')[0]}_kernel",),
        ((HD64, "test_ragged_prefill_hd64_matches_pallas"), HD64_ENGINE),
        "test_cuda_ragged_prefill_hd64")
       for a in ("bf16", "bf16_paged", "q8", "q8_paged")},
    "decode_attend_bf16_hd64": (
        ("_attend_bf16_kernel", "_attend_bf16_blocked_kernel", "_append_bf16_kernel"),
        (HD64_DECODE, HD64_ENGINE), ("test_cuda_decode_bf16_hd64",
                                     "test_cuda_decode_fused_append_hd64")),
    "decode_attend_bf16_paged_hd64": (
        ("_attend_bf16_paged_kernel", "_append_bf16_kernel"), (HD64_DECODE, HD64_ENGINE),
        ("test_cuda_decode_bf16_hd64", "test_cuda_decode_fused_append_hd64")),
    "decode_attention_bf16_hd64": (
        ("_decode_attn_kernel",), (HD64, "test_decode_attention_hd64_matches_pallas"),
        "test_cuda_decode_attention_hd64"),
    "decode_attend_q8_hd64": (
        ("_attend_q8_kernel", "_attend_q8_blocked_kernel", "_append_q8_kernel"),
        (HD64_Q8, HD64_ENGINE), ("test_cuda_q8_decode_hd64", "test_cuda_decode_fused_append_hd64")),
    "decode_attend_q8_paged_hd64": (
        ("_attend_q8_paged_kernel", "_append_q8_kernel"), (HD64_Q8, HD64_ENGINE),
        ("test_cuda_q8_decode_hd64", "test_cuda_decode_fused_append_hd64")),
}


def _pallas_bodies() -> set[str]:
    return set(re.findall(r"^def (_\w+_kernel)\(", PALLAS.read_text(), re.M))


def _entry_points() -> dict[str, str]:
    """{entry point: source file name} over every `extern "C"` in csrc/."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r'extern "C" int (\w+)\(', path.read_text()):
            out[name] = path.name
    return out


def _test_names(rel: str) -> set[str]:
    return set(re.findall(r"^def (test_\w+)\(", (ROOT / rel).read_text(), re.M))


def test_every_pallas_body_is_registered():
    """Each `def _*_kernel` of the JAX package's attention module stands
    behind at least one entry point, and each registered body exists."""
    bodies = _pallas_bodies()
    registered = {b for entry in PORT_PARITY.values() for b in entry[0]}
    assert len(bodies) == 16
    assert bodies - registered == set(), "Pallas bodies with no CUDA entry point"
    assert registered - bodies == set(), "registered bodies that are not in the JAX package"


def test_every_entry_point_is_registered():
    """Each `extern "C"` of the port's CUDA sources is in PORT_PARITY and
    nothing else is; the wrappers bind exactly these symbols."""
    entries = _entry_points()
    assert len(entries) == 29
    assert set(entries) == set(PORT_PARITY)
    assert set(P._SIGNATURES) == set(PORT_PARITY)


@pytest.mark.parametrize("entry", sorted(PORT_PARITY))
def test_port_parity_entry(entry):
    """The entry point's source, its wrapper binding, its Pallas bodies and
    every named test exist; each card test is marked `cuda`."""
    bodies, cpu_tests, card_tests = PORT_PARITY[entry]
    cpu_tests = (cpu_tests,) if isinstance(cpu_tests[0], str) else cpu_tests
    card_tests = (card_tests,) if isinstance(card_tests, str) else card_tests
    source = _entry_points()[entry]
    assert P._SIGNATURES[entry][0] == source[: -len(".cu")]
    assert set(bodies) <= _pallas_bodies()
    for cpu_file, cpu_test in cpu_tests:
        assert Path(cpu_file).name.startswith("test_torch_") and cpu_file != CARD
        assert cpu_test in _test_names(cpu_file), f"{cpu_file}::{cpu_test} does not exist"
    card = (ROOT / CARD).read_text()
    for card_test in card_tests:
        assert card_test in _test_names(CARD), f"{CARD}::{card_test} does not exist"
        decorators = card[: card.index(f"def {card_test}(")].rsplit("\n\n\n", 1)[-1]
        assert "@pytest.mark.cuda" in decorators, f"{card_test} is not marked cuda"
