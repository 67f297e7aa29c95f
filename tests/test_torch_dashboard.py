"""The port's streamlit dashboard (`omfs4d_torch/app/dashboard.py`), as
`tests/test_dashboard.py` drives the reference's: it runs wherever streamlit
is installed (neither this machine nor the card's has it, so the file skips
there).  The port's session and Pipeline take the CUDA card; without one the
dashboard's session raises, so these tests also skip without a card.  The
dashboard's calls into the port are held to its signatures without streamlit
in `tests/test_torch_session.py::test_dashboard_calls_bind_to_the_port`."""

from pathlib import Path

import pytest
import torch

pytest.importorskip("streamlit")
pytest.importorskip("streamlit.testing.v1")

from streamlit.testing.v1 import AppTest  # noqa: E402

DASHBOARD = str(Path(__file__).resolve().parent.parent
                / "omfs4d_torch" / "app" / "dashboard.py")


@pytest.fixture
def app():
    if not torch.cuda.is_available():
        pytest.skip("the port's planning session takes the CUDA card")
    at = AppTest.from_file(DASHBOARD, default_timeout=120)
    at.run()
    assert not at.exception, at.exception
    return at


def test_dashboard_boots_clean(app):
    assert any("Step 1" in h.value for h in app.header)


def test_demo_spheres_flow(app):
    next(b for b in app.button if "Demo spheres" in str(b.label)).click()
    app.run()
    assert not app.exception
    assert any("Step 2" in h.value for h in app.header)


def test_structure_checkboxes_exist(app):
    assert {"inc_lower", "inc_upper", "inc_teeth"} <= {cb.key for cb in app.checkbox}
