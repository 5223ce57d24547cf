"""The peak table printer (analysis/spectra.format_table) keeps the layout
of the reference's tabulate output: numbers re-formatted with "g",
decimal-aligned and right-justified, text left-justified."""

import pytest

from kat_tpu.analysis.spectra import format_table

PEAKS = ([["1", "12.50", "15.25", "18.00", "1.73", "1234", "567890", "1/2X"],
          ["2", "25.00", "30.10", "35.99", "2.50", "12", "5", "1X"],
          ["10", "-0.50", "100.00", "3.14", "10.00", "0", "123456789",
           "2X"]],
         ["Index", "Left", "Mean", "Right", "StdDev", "Max", "Volume",
          "Description"])


@pytest.mark.parametrize("rows,header,want", [
    (*PEAKS,
     "  Index    Left    Mean    Right    StdDev    Max     Volume  "
     "Description\n"
     "-------  ------  ------  -------  --------  -----  ---------  "
     "-------------\n"
     "      1    12.5   15.25    18         1.73   1234     567890  1/2X\n"
     "      2    25     30.1     35.99      2.5      12          5  1X\n"
     "     10    -0.5  100        3.14     10         0  123456789  2X"),
    ([["1", "5", "x"], ["22", "-7", "yy"]], ["Index", "Max", "Description"],
     "  Index    Max  Description\n-------  -----  -------------\n"
     "      1      5  x\n     22     -7  yy"),
    ([["1", "1234567.25", "2X"], ["2", "0.50", "3X"]],
     ["Index", "Mean", "Description"],
     "  Index         Mean  Description\n-------  -----------  -------------\n"
     "      1  1.23457e+06  2X\n      2  0.5          3X"),
], ids=["peaks", "integers", "exponent"])
def test_format_table_layout(rows, header, want):
    assert format_table(rows, header) == want
