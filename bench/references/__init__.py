"""Plain references, one file each, and the comparisons that decide correct."""
