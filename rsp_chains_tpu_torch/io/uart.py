"""Field-for-field functional analog of the reference's UART block, a copy of
``rsp_chains_tpu.io.uart`` (pure Python; the port keeps its own).

The reference serves its deployed chain over a memory-mapped UART
(`generators/uart/DSPBlockUART.scala:31-47,174-236`,
`UARTCtrlRegs.scala:5-19`): an AXI4-stream data path plus a CSR file
controlling enables, stop bits, watermark interrupts, the baud divisor,
optional parity generation/checking (with INDEPENDENT tx/rx parity modes),
optional CTS/RTS / RS-485 four-wire flow control, and an optional 9-bit data
mode. This framework's bulk transport is the CRC-framed TCP/byte protocol
(``io/framing.py`` — SURVEY §7 declares the electrical layer a non-goal), but
the reference's *register semantics* are behavior, not electronics — this
module maps them field-for-field so a register-level user of the reference
block finds every field at the same offset with the same reset and the same
read/write behavior.

What is modeled bit-true:
  - the line frame: start bit, 8/9 data bits LSB-first, the parity bit
    equation including the 9th-bit fold (`UARTTx.scala:42-46`), n stop bits;
  - the runtime frame-length arithmetic (`UARTTx.scala:47-51`): elaborated
    maximum minus the runtime 8-bit-mode and parity-disabled deductions;
  - parity checking with the independent-parity XOR on the receive side
    (`DSPBlockUART.scala:164`: ``rxm.parity := parity ^ includeIndependentParity``),
    the sticky ``errorparity`` bit and the ``errie``-gated second interrupt
    line (`DSPBlockUART.scala:165-166`);
  - watermark interrupt-pending semantics (`DSPBlockUART.scala:172-175`:
    ``ip.txwm = txq.count < txwm``, ``ip.rxwm = rxq.count > rxwm``) and the
    ``ie``-masked level interrupt;
  - four-wire flow control (`DSPBlockUART.scala:130-136,158`): TX gated on
    CTS when ``enwire4``, RTS = RX-FIFO-full in four-wire mode or
    ``tx_busy ^ invpol`` in RS-485 mode.

What is NOT modeled: bit timing (the divisor register exists, validates, and
readbacks, but wall-clock baud emulation is out of scope) and the
``nSamples``-way majority voter (the line here is lossless bits, not an
analog pin; the parameter is kept and validated for config parity).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


class UartRegs:
    """Register offsets — identical to `UARTCtrlRegs.scala:5-19`."""

    txfifo = 0x00
    rxfifo = 0x04
    txctrl = 0x08
    txmark = 0x0A
    rxctrl = 0x0C
    rxmark = 0x0E
    ie = 0x10
    ip = 0x14
    div = 0x18
    parity = 0x1C
    wire4 = 0x20
    either8or9 = 0x24


@dataclass(frozen=True)
class UartParams:
    """Elaboration parameters — same fields, defaults, and ``require`` rules
    as `DSPBlockUART.scala:31-47` (``UARTParams``)."""

    data_bits: int = 8
    stop_bits: int = 2
    divisor_bits: int = 16
    oversample: int = 4
    n_samples: int = 3
    n_tx_entries: int = 8
    n_rx_entries: int = 8
    include_four_wire: bool = False
    include_parity: bool = False
    include_independent_parity: bool = False

    @property
    def oversample_factor(self) -> int:
        return 1 << self.oversample

    def __post_init__(self):
        if self.divisor_bits <= self.oversample:
            raise ValueError("divisorBits must exceed oversample")
        if self.oversample_factor <= self.n_samples:
            raise ValueError("oversampleFactor must exceed nSamples")
        if self.data_bits not in (8, 9):
            raise ValueError("dataBits must be 8 or 9")
        if self.include_independent_parity and not self.include_parity:
            raise ValueError("independent parity requires includeParity")


def _parity8(v: int) -> int:
    v &= 0xFF
    v ^= v >> 4
    v ^= v >> 2
    v ^= v >> 1
    return v & 1


class DspBlockUart:
    """The UART block as a host-side component: a CSR file at the reference
    offsets plus the bit-level line codec. ``poke``/``peek`` mirror AXI4-Lite
    32-bit accesses; the stream side is ``submit`` (AXI4-stream in → TX FIFO)
    and ``collect`` (RX FIFO → AXI4-stream out)."""

    def __init__(self, params: UartParams = UartParams(),
                 divisor_init: int = 868):
        # `DSPBlockUART.scala:84-85`: divisor must be nonzero and fit the reg
        if divisor_init == 0:
            raise ValueError("UART divisor wasn't initialized")
        if divisor_init >> params.divisor_bits:
            raise ValueError(
                f"UART divisor reg (width {params.divisor_bits}) not wide "
                f"enough to hold {divisor_init}")
        self.params = params
        self._txq: deque[int] = deque()
        self._rxq: deque[int] = deque()
        # register resets — `DSPBlockUART.scala:115-126`
        self.div = divisor_init
        self.txen = 0
        self.rxen = 0
        self.nstop = 0
        self.txwm = 0
        self.rxwm = 0
        self.ie_txwm = 0
        self.ie_rxwm = 0
        self.enparity = 0
        self.parity = 0          # 1 = odd, 0 = even
        self.errorparity = 0     # sticky
        self.errie = 0
        self.enwire4 = 0         # 1 = CTS/RTS, 0 = RS-485
        self.invpol = 0
        self.data8or9 = 1        # 1 = 8 data bits, 0 = 9 (reset per RegField)
        # four-wire input pin state (peer drives via set_cts)
        self.cts_n = 0
        self._tx_busy = False

    # ---- stream side ----------------------------------------------------

    def submit(self, *words: int) -> int:
        """AXI4-stream slave side into the TX queue (bounded; returns how
        many words were accepted — ``in.ready`` drops when the queue fills,
        `DSPBlockUART.scala:141-143`)."""
        took = 0
        for w in words:
            if len(self._txq) >= self.params.n_tx_entries:
                break
            self._txq.append(int(w) & 0x1FF)
            took += 1
        return took

    def collect(self) -> list[int]:
        """Drain the RX queue (AXI4-stream master side,
        `DSPBlockUART.scala:145-147`)."""
        out = list(self._rxq)
        self._rxq.clear()
        return out

    # ---- line codec ------------------------------------------------------

    def frame_bits(self, word: int) -> list[int]:
        """Serialize one word to line bits (LSB of the list transmitted
        first): start(0), data LSB-first, optional {bit9, parity} per
        `UARTTx.scala:42-46`, ``nstop + 1`` stop bits (`UARTTx.scala:47-57`:
        elaborated max length minus the runtime 8-bit-mode and
        parity-disabled deductions)."""
        p = self.params
        word &= 0x1FF
        nine = p.data_bits == 9 and not self.data8or9
        bits = [0] + [(word >> i) & 1 for i in range(8)]
        if nine:
            bits.append((word >> 8) & 1)
        if p.include_parity and self.enparity:
            bit9 = (word >> 8) & 1 if nine else 0
            bits.append(bit9 ^ _parity8(word) ^ self.parity)
        bits += [1] * (self.nstop + 1)
        return bits

    def transmit(self):
        """Pop one TX word and return its line bits, honoring the enable and
        four-wire CTS gate (`DSPBlockUART.scala:130-136`: TX runs only when
        ``txen`` and, with ``enwire4``, CTS is asserted). Returns None when
        gated or empty."""
        gated = self.params.include_four_wire and self.enwire4 and self.cts_n
        if not self.txen or gated or not self._txq:
            self._tx_busy = bool(self._txq) and bool(self.txen)
            return None
        w = self._txq.popleft()
        self._tx_busy = True
        bits = self.frame_bits(w)
        self._tx_busy = bool(self._txq)
        return bits

    def receive(self, bits: list[int]) -> bool:
        """Decode one line frame into the RX queue; returns acceptance.
        Parity is checked with the receive-side mode
        ``parity ^ includeIndependentParity`` (`DSPBlockUART.scala:162-166`);
        a failed check sets the STICKY ``errorparity`` but the word is STILL
        delivered (`UARTRx.scala:90-99`: ``valid`` fires at ``data_last``
        regardless of the parity outcome — matching this exactly). Stop-bit
        levels are not checked (the reference samples ``data_last`` at the
        stop position without testing the line). A full queue drops the word
        (``Queue`` backpressure)."""
        p = self.params
        if not self.rxen:
            return False
        if bits[0] != 0:
            return False                      # no start bit — not a frame
        nine = p.data_bits == 9 and not self.data8or9
        ndata = 9 if nine else 8
        data = 0
        for i in range(ndata):
            data |= (bits[1 + i] & 1) << i
        pos = 1 + ndata
        if p.include_parity and self.enparity:
            rx_parity_mode = self.parity ^ int(p.include_independent_parity)
            want = ((data >> 8) & 1) ^ _parity8(data) ^ rx_parity_mode
            if bits[pos] != want:
                self.errorparity = 1          # sticky; word still delivered
        if len(self._rxq) >= self.params.n_rx_entries:
            return False
        self._rxq.append(data)
        return True

    # ---- interrupts / pins ----------------------------------------------

    @property
    def ip_txwm(self) -> int:
        return int(len(self._txq) < self.txwm)   # DSPBlockUART.scala:172

    @property
    def ip_rxwm(self) -> int:
        return int(len(self._rxq) > self.rxwm)   # DSPBlockUART.scala:173

    @property
    def interrupts(self) -> list[int]:
        """interrupt[0] = watermark, interrupt[1] (if parity) = sticky parity
        error gated by ``errie`` (`DSPBlockUART.scala:166,175`)."""
        wm = int((self.ip_txwm and self.ie_txwm)
                 or (self.ip_rxwm and self.ie_rxwm))
        if self.params.include_parity:
            return [wm, int(self.errorparity and self.errie)]
        return [wm]

    @property
    def rts_n(self):
        """`DSPBlockUART.scala:158`: four-wire mode asserts RTS (low) while
        the RX FIFO has room; RS-485 mode drives ``tx_busy ^ invpol``."""
        if not self.params.include_four_wire:
            return None
        if self.enwire4:
            return int(len(self._rxq) >= self.params.n_rx_entries)
        return int(self._tx_busy) ^ self.invpol

    def set_cts(self, cts_n: int) -> None:
        if not self.params.include_four_wire:
            raise ValueError("CTS pin requires includeFourWire")
        self.cts_n = int(cts_n)

    # ---- CSR file --------------------------------------------------------

    def poke(self, offset: int, value: int) -> None:
        """32-bit register write at the reference offsets; fields pack LSB-up
        in declaration order (rocket-chip ``RegField`` sequence packing)."""
        p, v = self.params, int(value)
        if offset == UartRegs.txfifo:
            self.submit(v)                     # nonblocking enqueue
        elif offset == UartRegs.txctrl:
            self.txen = v & 1
            stop_bits = max((p.stop_bits - 1).bit_length(), 1)
            self.nstop = (v >> 1) & ((1 << stop_bits) - 1)
        elif offset == UartRegs.rxctrl:
            self.rxen = v & 1
        elif offset == UartRegs.txmark:
            self.txwm = v & ((1 << (p.n_tx_entries.bit_length())) - 1)
        elif offset == UartRegs.rxmark:
            self.rxwm = v & ((1 << (p.n_rx_entries.bit_length())) - 1)
        elif offset == UartRegs.ie:
            self.ie_txwm, self.ie_rxwm = v & 1, (v >> 1) & 1
        elif offset == UartRegs.div:
            self.div = v & ((1 << p.divisor_bits) - 1)
        elif offset == UartRegs.parity and p.include_parity:
            self.enparity = v & 1
            self.parity = (v >> 1) & 1
            self.errorparity = (v >> 2) & 1    # W1-writable sticky (RegField)
            self.errie = (v >> 3) & 1
        elif offset == UartRegs.wire4 and p.include_four_wire:
            self.enwire4, self.invpol = v & 1, (v >> 1) & 1
        elif offset == UartRegs.either8or9 and p.data_bits == 9:
            self.data8or9 = v & 1
        elif offset == UartRegs.ip:
            pass                               # read-only pending bits
        else:
            raise KeyError(f"no register at {offset:#x} in this elaboration")

    def peek(self, offset: int) -> int:
        p = self.params
        if offset == UartRegs.rxfifo:
            # nonblocking dequeue: bit 31 = empty, low bits = data
            if not self._rxq:
                return 1 << 31
            return self._rxq.popleft()
        if offset == UartRegs.txfifo:
            return int(len(self._txq) >= p.n_tx_entries) << 31   # full flag
        if offset == UartRegs.txctrl:
            return self.txen | (self.nstop << 1)
        if offset == UartRegs.rxctrl:
            return self.rxen
        if offset == UartRegs.txmark:
            return self.txwm
        if offset == UartRegs.rxmark:
            return self.rxwm
        if offset == UartRegs.ie:
            return self.ie_txwm | (self.ie_rxwm << 1)
        if offset == UartRegs.ip:
            return self.ip_txwm | (self.ip_rxwm << 1)
        if offset == UartRegs.div:
            return self.div
        if offset == UartRegs.parity and p.include_parity:
            return (self.enparity | (self.parity << 1)
                    | (self.errorparity << 2) | (self.errie << 3))
        if offset == UartRegs.wire4 and p.include_four_wire:
            return self.enwire4 | (self.invpol << 1)
        if offset == UartRegs.either8or9 and p.data_bits == 9:
            return self.data8or9
        raise KeyError(f"no register at {offset:#x} in this elaboration")
