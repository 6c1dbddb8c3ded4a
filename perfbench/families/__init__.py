"""The program's model of each configuration family, by family name."""
