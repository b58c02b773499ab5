"""Drivers of the program's engines, one file per engine kind."""
