"""Segment lists for the grouped kernels' tests (kernels 2 and 5, one launch
over a round's segment list): the 61 leaf widths of cifar_cnn_full in tree
order (272,282 columns; the 10-wide fc bias first, so every later leaf
starts off the 4-column grid of the delta), and widths 1, 10 and 4097 at
column offsets 0, 1 and 11."""

import numpy as np

from repro_torch.configs import colrel_paper
from repro_torch.core import flatten
from repro_torch.models.cnn import CNN

SEGMENT_WIDTHS = {
    "cifar_cnn_full": tuple(int(np.prod(s)) for s in flatten.flat_spec(
        CNN(colrel_paper.full().cnn).param_tree()).shapes),
    "off_grid": (1, 10, 4097),
}
