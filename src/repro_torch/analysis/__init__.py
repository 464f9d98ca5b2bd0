"""Analysis: the roofline of a cell on the H100 (``roofline``)."""
