"""InterWrap (Solution 3) page gather / in-place scatter."""
