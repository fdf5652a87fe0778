"""Counts of the work a cell asks for, taken from the plain reference and
from call shapes, never from the port: model FLOPs (`flops`) and the bytes
of the port's kernel launches (`kernel_bytes`)."""
