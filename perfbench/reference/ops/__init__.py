"""Part of the frozen plain reference."""
