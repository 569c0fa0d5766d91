"""R1 fixture: re-derives a marker constant instead of importing it."""


def marker_for(slot: int) -> int:
    # the golden multiplier, inlined — must come from compression.framing
    return (slot * 0x9E3779B1) & 0xFFFFFFFF
