"""File input of the port: RAW containers (DNG, RAF) decoded on the host,
developed on the device; sidecars; the loader."""
