"""Each kernel's operations and bytes, from the shapes of its launch."""
