"""State-id encoding (parity: c-core/state.h:9-25, state.c).

16-bit ids: top 2 bits select the class (M=0, I=1, D=2, X=3); core states
carry the 1-based node index in the low 14 bits; special states are X|0..9.

The benchmark's frozen copy of the arithmetic of
deciphon_tpu/states.py (and of deciphon_tpu_torch's copy of it); the reference never
imports the program.
"""

from __future__ import annotations

STATE_ID_BITS = 16
_CLS_SHIFT = STATE_ID_BITS - 2

STATE_M = 0 << _CLS_SHIFT
STATE_I = 1 << _CLS_SHIFT
STATE_D = 2 << _CLS_SHIFT
STATE_X = 3 << _CLS_SHIFT

STATE_F = STATE_X | 0
STATE_R = STATE_X | 1
STATE_G = STATE_X | 2
STATE_S = STATE_X | 3
STATE_N = STATE_X | 4
STATE_B = STATE_X | 5
STATE_E = STATE_X | 6
STATE_J = STATE_X | 7
STATE_C = STATE_X | 8
STATE_T = STATE_X | 9


def make_match_id(idx: int) -> int:
    return STATE_M | (idx + 1)


def make_insert_id(idx: int) -> int:
    return STATE_I | (idx + 1)


def make_delete_id(idx: int) -> int:
    return STATE_D | (idx + 1)


def state_class(sid: int) -> int:
    return sid & (3 << _CLS_SHIFT)


def is_match(sid: int) -> bool:
    return state_class(sid) == STATE_M


def is_insert(sid: int) -> bool:
    return state_class(sid) == STATE_I


def is_delete(sid: int) -> bool:
    return state_class(sid) == STATE_D


def is_core(sid: int) -> bool:
    return state_class(sid) != STATE_X


def core_idx(sid: int) -> int:
    """0-based node index of a core state (state.c state_core_idx)."""
    return (sid & (0xFFFF >> 2)) - 1


def state_name(sid: int) -> str:
    """Human name: 'M12', 'S', ... (state.c state_name)."""
    cls = state_class(sid)
    if cls == STATE_X:
        return {
            STATE_F: "F", STATE_R: "R", STATE_G: "G", STATE_S: "S",
            STATE_N: "N", STATE_B: "B", STATE_E: "E", STATE_J: "J",
            STATE_C: "C", STATE_T: "T",
        }[sid]
    prefix = {STATE_M: "M", STATE_I: "I", STATE_D: "D"}[cls]
    return f"{prefix}{core_idx(sid) + 1}"
