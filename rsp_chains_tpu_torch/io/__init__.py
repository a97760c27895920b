"""The serving and control plane of the port: the wire framing and its native
scanner, the UART register model, the streaming pipeline, the CPI buffer and
checkpoints, the debug control port and the TCP chain server."""

from . import native
from .control import ControlServer, poke
from .framing import (
    FLAG_CONFIG,
    FLAG_LAST,
    Frame,
    FrameDecoder,
    FrameError,
    decode_frame,
    encode_frame,
    encode_iq_frame,
)
from .stream import CpiMetrics, StreamingPipeline, StreamStats
from .uart import DspBlockUart, UartParams, UartRegs
