"""File input of the port: RAW containers decoded on the host and
developed on the device, LDR images (JPEG, PNG, TIFF, float formats, JXL)
through the port's own decoders; sidecars, EXIF, LUTs; the loader."""
