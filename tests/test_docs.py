"""Documentation examples actually run (the reference's doc-test on
DynamicAvx2Searcher, src/x86.rs:1-15, runs under cargo test)."""


def test_package_docstring_example():
    import sliceslice_tpu as st

    s = st.DynamicSearcher(b"ipsum")
    assert s.search_in(b"lorem ipsum dolor") is True
    assert s.find(b"lorem ipsum dolor") == 6
    assert list(s.positions(b"lorem ipsum, ipsum")) == [6, 13]
    assert list(s.find_iter(b"lorem ipsum, ipsum")) == [6, 13]
    assert st.DynamicSearcher(b"aba").count_in(b"ababa") == 2  # overlapping

    hay = st.preprocess(b"some corpus with a needle inside" * 40)
    got = st.BatchedSearcher([b"a", b"needle"]).find_all(hay)
    assert list(got) == [17, 19]


def test_version_gate():
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "scripts/check_version.py"], capture_output=True
    )
    assert r.returncode == 0, r.stderr


def test_readme_scripts_exist():
    """Every script the README tells a reader to run is in the tree."""
    import os
    import re

    readme = open("README.md").read()
    paths = set(re.findall(r"python3? ([\w./-]+\.py)", readme))
    assert "chip_smoke.py" in paths
    missing = sorted(p for p in paths if not os.path.exists(p))
    assert not missing, missing
