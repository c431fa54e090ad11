"""Bit constants (mirrors the lib0/binary module used throughout the
reference wire format, e.g. reference src/structs/Item.js:629-632)."""

BIT1 = 1
BIT2 = 2
BIT3 = 4
BIT4 = 8
BIT5 = 16
BIT6 = 32
BIT7 = 64
BIT8 = 128

BITS5 = 0b11111
BITS6 = 0b111111
BITS7 = 0b1111111
BITS31 = 0x7FFFFFFF
BITS32 = 0xFFFFFFFF
