"""World System Teletext (WST) packets on the VBI data-line layer.

Port of ``color_modem_tpu/frame/teletext.py``.  A packet is a clock
run-in, the framing code, two Hamming-8/4 address bytes and 40 payload
bytes (odd-parity characters on display rows; eight Hamming bytes, then 32
characters, in the page header).  A page is one header packet (X/0) and
up to 25 display rows.  Real WST clocks 444 fh, which needs the 27 MHz
(1440-sample) grid: :func:`wst_spec` refuses narrower grids.

All the rows of a page encode and decode in one batched data-line call,
and Hamming correction is a 256-entry table lookup.  The packet parse runs
on the host, over the decoded integers, after one stacked fetch.  Every
bit array is in transmission order (each byte LSB first).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.frame.pipeline import Plan, resolve_device
from color_modem_tpu_torch.frame.vbi import DataLineSpec, decode_data_line, encode_data_line
from color_modem_tpu_torch.utils.upload import upload

PACKET_BYTES = 42          # 2 address + 40 payload (the framing code is framing)
PACKET_BITS = PACKET_BYTES * 8
ROW_CHARS = 40             # display row payload
HEADER_CHARS = 32          # header payload after the 8 Hamming bytes

#: framing code 0xE4 (11100100), LSB first
_FRAMING_LSB_FIRST = (0, 0, 1, 0, 0, 1, 1, 1)

#: Hamming 8/4 codewords of the nibbles 0..15 (ETS 300 706 table 36)
_HAM84_CODE = np.array(
    [0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
     0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA],
    dtype=np.int64,
)


def _ham84_tables() -> tuple[np.ndarray, np.ndarray]:
    """256-entry decode tables: corrected nibble, and ok flag.  A byte equal
    to a codeword or one bit away from one decodes to its nibble (ok=1);
    anything else is an uncorrectable error (nibble 0, ok=0)."""
    val = np.zeros(256, np.int64)
    ok = np.zeros(256, np.int64)
    for nib, cw in enumerate(_HAM84_CODE):
        val[cw], ok[cw] = nib, 1
        for b in range(8):
            val[cw ^ (1 << b)], ok[cw ^ (1 << b)] = nib, 1
    return val, ok


_HAM84_VAL, _HAM84_OK = _ham84_tables()
#: the three tables, stacked: codeword, corrected nibble, ok flag
_TABLES = np.stack([np.pad(_HAM84_CODE, (0, 240)), _HAM84_VAL, _HAM84_OK]).astype(np.int32)


@lru_cache(maxsize=8)
def _tables(device: torch.device) -> torch.Tensor:
    """The Hamming tables on ``device``, uploaded once."""
    return upload(_TABLES, device)


def hamming84_encode(nibbles) -> torch.Tensor:
    """(...,) nibbles 0..15 -> (..., 8) int32 codeword bits, LSB first, on
    the nibbles' device (the host for a list or array)."""
    n = torch.as_tensor(nibbles).to(torch.int64)
    cw = _tables(n.device)[0][n]
    shifts = torch.arange(8, dtype=torch.int32, device=n.device)
    return (cw[..., None] >> shifts) & 1


def hamming84_decode(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 8) received bits -> ((...,) nibble, (...,) ok flag), int32."""
    b = torch.as_tensor(bits).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    byte = (b << shifts).sum(-1).to(torch.int64)
    tables = _tables(b.device)
    return tables[1][byte], tables[2][byte]


def _parity_bytes(text: str, n: int) -> np.ndarray:
    """Text -> (n, 8) odd-parity 7-bit character bits, LSB first."""
    out = np.zeros((n, 8), np.int64)
    for i, ch in enumerate(text.ljust(n)[:n]):
        v = ord(ch)
        if v > 0x7F:
            raise ValueError(f"teletext level 1 is 7-bit: {ch!r}")
        data = [(v >> k) & 1 for k in range(7)]
        out[i, :7] = data
        out[i, 7] = 1 - (sum(data) % 2)
    return out


def _chars_from_bits(bits: np.ndarray) -> tuple[str, np.ndarray]:
    """(n, 8) decoded bits -> (text, per-character parity-ok flags); a cell
    that fails parity renders as '?'."""
    data = (bits[:, :7] * (1 << np.arange(7))).sum(axis=1)
    ok = bits.sum(axis=1) % 2 == 1
    return "".join(chr(int(v)) if o else "?" for v, o in zip(data, ok)), ok


def wst_spec(plan: Plan) -> DataLineSpec:
    """Full-rate WST: 444 fh NRZ, 42-byte packets, the alternating 16-bit
    run-in and 100% cosine roll-off shaping.  Needs the wide (>= 27 MHz)
    sample grid."""
    f_bit = 444.0 * plan.cfg.fh
    if plan.fs / f_bit < 3.0:
        raise ValueError(
            f"WST at {f_bit/1e6:.3f} Mbit/s needs >=3 samples/bit; "
            f"fs={plan.fs/1e6:.2f} MHz gives {plan.fs/f_bit:.2f} — use "
            f"width >= 1440 (27 MHz grid) for full-rate teletext"
        )
    return DataLineSpec(f_bit=f_bit, n_bits=PACKET_BITS, run_in_cycles=8, level=0.66,
                        start_bits=_FRAMING_LSB_FIRST, run_in_alt=True)


def _address_bits(magazine: int, packet: int) -> np.ndarray:
    """Magazine 1..8, packet 0..31 -> (2, 8) Hamming address bytes (WST
    codes magazine 8 as 0)."""
    if not 1 <= magazine <= 8:
        raise ValueError(f"magazine must be 1..8, got {magazine}")
    if not 0 <= packet <= 31:
        raise ValueError(f"packet must be 0..31, got {packet}")
    addr = (packet << 3) | (magazine % 8)  # M1 M2 M3 Y1..Y5
    return hamming84_encode(np.array([addr & 0xF, addr >> 4])).numpy()


def row_packet_bits(magazine: int, row: int, text: str) -> torch.Tensor:
    """Display row (packet X/1..X/25): (PACKET_BITS,) int32 host bits."""
    if not 1 <= row <= 25:
        raise ValueError(f"display rows are packets 1..25, got {row}")
    bits = np.concatenate([_address_bits(magazine, row), _parity_bytes(text, ROW_CHARS)])
    return torch.tensor(bits.reshape(-1), dtype=torch.int32)


def header_packet_bits(magazine: int, page: int, subcode: int = 0,
                       text: str = "") -> torch.Tensor:
    """Page header (packet X/0): page number and subcode in Hamming bytes
    (control bits 0: a plain page), then 32 odd-parity characters.
    ``page`` is the two-digit hex page number 0x00..0xFF."""
    if not 0 <= page <= 0xFF:
        raise ValueError(f"page number is two hex digits, got {page:#x}")
    if not 0 <= subcode <= 0x3FFF:
        raise ValueError(f"subcode is 13 bits + control, got {subcode:#x}")
    nibbles = np.array([page & 0xF, (page >> 4) & 0xF, subcode & 0xF, (subcode >> 4) & 0x7,
                        (subcode >> 7) & 0xF, (subcode >> 11) & 0x3, 0, 0])
    bits = np.concatenate([_address_bits(magazine, 0), hamming84_encode(nibbles).numpy(),
                           _parity_bytes(text, HEADER_CHARS)])
    return torch.tensor(bits.reshape(-1), dtype=torch.int32)


def encode_page(plan: Plan, magazine: int, page: int, rows: list[str], header: str = "",
                device: torch.device | str = "cuda") -> torch.Tensor:
    """A page -> (1 + len(rows), N) data-line waveforms on ``device``: row 0
    is the header, ``rows[i]`` display packet i+1, all in one batched
    data-line call (the bits are copied to the card without synchronising it)."""
    if len(rows) > 25:
        raise ValueError(f"a page has at most 25 display rows, got {len(rows)}")
    spec = wst_spec(plan)
    bits = torch.stack([header_packet_bits(magazine, page, text=header)]
                       + [row_packet_bits(magazine, i + 1, t) for i, t in enumerate(rows)])
    return encode_data_line(plan, spec, upload(bits.numpy(), resolve_device(device)))


@dataclasses.dataclass(frozen=True)
class TeletextPacket:
    """One decoded packet (host-side view)."""

    magazine: int
    packet: int
    address_ok: bool
    text: str
    parity_ok: np.ndarray      # per-character flags
    page: int | None = None    # header packets only
    subcode: int | None = None
    header_ok: bool = True     # Hamming flags on the header bytes
    margin: float = 0.0        # slicing eye margin from the data-line layer


def decode_packets(plan: Plan, lines: torch.Tensor) -> list[TeletextPacket]:
    """(R, N) received data lines -> R parsed packets.  The slicing and the
    Hamming lookups run batched on the lines' device; the bits, margins and
    Hamming results come back in one stacked fetch for the host parse."""
    spec = wst_spec(plan)
    bits, margin = decode_data_line(plan, spec, lines)
    bytes_ = bits.reshape(bits.shape[:-1] + (PACKET_BYTES, 8))
    addr_val, addr_ok = hamming84_decode(bytes_[..., :2, :])
    ham_val, ham_ok = hamming84_decode(bytes_[..., 2:10, :])
    # every integer here is below 2^8, exact in float32 beside the margin
    fetched = torch.cat([bits.to(torch.float32), margin[..., None],
                         *(a.to(torch.float32) for a in (addr_val, addr_ok, ham_val, ham_ok))],
                        dim=-1).cpu().numpy()
    cuts = np.cumsum([PACKET_BITS, 1, 2, 2, 8])
    bits_h, margin_h, addr_val, addr_ok, ham_val, ham_ok = np.split(fetched, cuts, axis=-1)
    bits_h = bits_h.astype(np.int64)
    addr_val, addr_ok, ham_val, ham_ok = (a.astype(np.int64)
                                          for a in (addr_val, addr_ok, ham_val, ham_ok))
    out = []
    for r in range(bits_h.shape[0]):
        addr = int(addr_val[r, 0]) | (int(addr_val[r, 1]) << 4)
        mag, packet = addr & 0x7, addr >> 3
        row_bits = bits_h[r].reshape(PACKET_BYTES, 8)
        common = dict(magazine=8 if mag == 0 else mag, packet=packet,
                      address_ok=bool(addr_ok[r].all()), margin=float(margin_h[r, 0]))
        if packet == 0:
            page = int(ham_val[r, 0]) | (int(ham_val[r, 1]) << 4)
            subcode = (int(ham_val[r, 2]) | ((int(ham_val[r, 3]) & 0x7) << 4)
                       | (int(ham_val[r, 4]) << 7) | ((int(ham_val[r, 5]) & 0x3) << 11))
            text, ok = _chars_from_bits(row_bits[10:])
            out.append(TeletextPacket(text=text, parity_ok=ok, page=page, subcode=subcode,
                                      header_ok=bool(ham_ok[r].all()), **common))
        else:
            text, ok = _chars_from_bits(row_bits[2:])
            out.append(TeletextPacket(text=text, parity_ok=ok, **common))
    return out


def render_page(packets: list[TeletextPacket]) -> str:
    """Decoded packets -> the page as display text (header first, display
    rows in packet order, missing rows blank)."""
    rows: dict[int, str] = {}
    header = ""
    for p in packets:
        if p.packet == 0:
            header = p.text.rstrip()
        elif 1 <= p.packet <= 25:
            rows[p.packet] = p.text.rstrip()
    body = [rows.get(i, "") for i in range(1, max(rows) + 1)] if rows else []
    return "\n".join([header] + body).rstrip()
