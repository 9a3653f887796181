# Port of pqa2_tpu/ui/tabs/help_tab.py: the installation and troubleshooting
# sections describe the PyTorch/CUDA port.
"""HelpTab — static documentation.

Rebuild of app/ui/tabs/help_tab.py: quick start (:91), user guide (:168),
installation (:331), VMAF primer (:422), troubleshooting (:617) and the
capture-formats reference (:844) as HTML sections."""

from __future__ import annotations

from PyQt5.QtWidgets import QTabWidget, QTextBrowser, QVBoxLayout, QWidget


def _browser(html: str) -> QTextBrowser:
    b = QTextBrowser()
    b.setHtml(html)
    return b


class HelpTab(QWidget):
    def __init__(self, parent=None):
        super().__init__()
        layout = QVBoxLayout(self)
        tabs = QTabWidget()
        tabs.addTab(_browser(self._get_quick_start_content()), "Quick start")
        tabs.addTab(_browser(self._get_user_guide_content()), "User guide")
        tabs.addTab(_browser(self._get_installation_content()), "Installation")
        tabs.addTab(_browser(self._get_vmaf_primer_content()), "About VMAF")
        tabs.addTab(_browser(self._get_troubleshooting_content()), "Troubleshooting")
        tabs.addTab(_browser(self._get_capture_formats_content()),
                    "Capture formats")
        layout.addWidget(tabs)

    def _get_quick_start_content(self) -> str:
        return """
        <h2>Quick start</h2>
        <ol>
          <li><b>Setup tab</b>: choose a reference video; it is analyzed
              automatically (resolution, frame rate, bookends).</li>
          <li><b>Capture tab</b>: pick a device and press <i>Start bookend
              capture</i>. The reference should be playing in a loop with
              white bookend frames through the device under test. Without
              hardware, choose <i>File playback (simulated)</i>.</li>
          <li><b>Analysis tab</b>: pick a VMAF model and run the combined
              analysis — the capture is temporally aligned via its white
              bookends and scored (VMAF + PSNR + SSIM) on the accelerator.</li>
          <li><b>Results tab</b>: scores with quality interpretation,
              PDF/HTML/CSV export, and the history of past tests.</li>
        </ol>"""

    def _get_user_guide_content(self) -> str:
        return """
        <h2>User guide</h2>
        <h3>Bookend workflow</h3>
        <p>The reference clip is played in a loop with pure white frames
        ("bookends") between repetitions. The aligner locates the white
        sections in the capture with a batched luma-statistics pass, picks
        the loop whose length best matches the reference, refines the offset
        by cross-correlation, and scores the aligned pair.</p>
        <h3>Models</h3>
        <p>All standard Netflix models ship preparsed: vmaf_v0.6.1 (HD),
        vmaf_v0.6.1neg (no enhancement gain), vmaf_4k_v0.6.1, and the
        vmaf_b_v0.6.3 bootstrap ensemble with confidence intervals.</p>
        <h3>Outputs</h3>
        <p>Each test produces a <code>&lt;name&gt;_&lt;timestamp&gt;</code>
        directory holding the libvmaf-schema <code>*_vmaf.json</code>,
        ffmpeg-format <code>*_psnr.txt</code>/<code>*_ssim.txt</code>, and
        <code>metadata.json</code>.</p>"""

    def _get_installation_content(self) -> str:
        # Reference parity: help_tab.py:331 (install guide).
        return """
        <h2>Installation</h2>
        <h3>Requirements</h3>
        <ul>
          <li>Python 3.10+ with <code>torch</code> built for CUDA and
              <code>numpy</code> (the scoring engine), an NVIDIA sm_90 card
              (H100/H200) and the CUDA toolkit's <code>nvcc</code>: the
              CUDA kernels are built by nvcc from the package's
              <code>csrc/</code> sources on first use, into
              <code>build/pqa2_tpu_torch/</code>. Without a card the engine
              runs its plain PyTorch versions only where the caller asks for
              the CPU (<code>--device cpu</code>).</li>
          <li><i>Optional:</i> <code>PyQt5</code> for the desktop UI — the
              CLI (<code>python -m pqa2_tpu_torch.cli --help</code>) and the
              engine API work without it.</li>
          <li><i>Optional:</i> <code>opencv-python</code> and
              <code>ffmpeg</code> for compressed-container ingest (mp4/mkv)
              and DeckLink capture; raw <code>.y4m</code> clips decode
              in-process with no external tools.</li>
          <li><i>Optional:</i> <code>matplotlib</code> for PDF report
              charts.</li>
        </ul>
        <h3>Install</h3>
        <p><code>pip install -e .</code> from the repository root installs
        the <code>pqa2_tpu_torch</code> package; start the window with
        <code>python -m pqa2_tpu_torch.main</code> (<code>--device
        cpu</code> for a machine without a card). Model files ship
        preparsed inside the package — no model download step.</p>
        <h3>Capture hardware</h3>
        <p>For Blackmagic DeckLink / Intensity Shuttle capture, install the
        vendor's Desktop Video drivers and an ffmpeg build with
        <code>--enable-decklink</code>; set its path under Options &rarr;
        General if it is not on PATH. Verify with the Capture tab's
        <i>Refresh devices</i>.</p>
        <h3>Self-check</h3>
        <p><code>python -m pytest tests/test_torch_*.py -q</code> runs the
        port's tests on the CPU; <code>python -m pqa2_tpu_torch.cli probe
        &lt;file&gt;</code> checks ingest of a specific clip.</p>"""

    def _get_capture_formats_content(self) -> str:
        # Reference parity: help_tab.py:844 (capture formats reference).
        return """
        <h2>Capture formats</h2>
        <p>DeckLink devices identify modes by four-character format codes.
        The capture backend probes each device for its supported list
        (Options &rarr; Capture &rarr; detect formats); common modes:</p>
        <table border="1" cellspacing="0" cellpadding="4">
          <tr><th>Code</th><th>Mode</th><th>Resolution</th><th>Rate</th></tr>
          <tr><td>ntsc</td><td>NTSC SD</td><td>720&times;486</td><td>29.97i</td></tr>
          <tr><td>pal</td><td>PAL SD</td><td>720&times;576</td><td>25i</td></tr>
          <tr><td>Hp29</td><td>1080p29.97</td><td>1920&times;1080</td><td>29.97p</td></tr>
          <tr><td>Hp30</td><td>1080p30</td><td>1920&times;1080</td><td>30p</td></tr>
          <tr><td>Hp59</td><td>1080p59.94</td><td>1920&times;1080</td><td>59.94p</td></tr>
          <tr><td>Hi59</td><td>1080i59.94</td><td>1920&times;1080</td><td>29.97i</td></tr>
          <tr><td>hp59</td><td>720p59.94</td><td>1280&times;720</td><td>59.94p</td></tr>
          <tr><td>hp60</td><td>720p60</td><td>1280&times;720</td><td>60p</td></tr>
        </table>
        <p>Pixel format: capture runs in <code>uyvy422</code> (the
        DeckLink wire format) and is converted in-process (BT.601/709
        matrix by resolution) before scoring. Intensity Shuttle devices
        that fail format probing fall back to a built-in mode table.</p>
        <p>Choose the format matching the device under test's output
        exactly — a rate mismatch shows up as alignment failures or
        duplicated frames in the captured clip.</p>"""

    def _get_vmaf_primer_content(self) -> str:
        return """
        <h2>About VMAF</h2>
        <p>VMAF (Video Multi-method Assessment Fusion) predicts perceptual
        video quality by fusing elementary features — VIF at four scales,
        ADM detail-loss, and temporal motion — with a support-vector
        regressor trained on subjective scores. Scores range 0–100:</p>
        <ul><li>&ge;90 excellent</li><li>80–90 good</li><li>70–80 fair</li>
        <li>60–70 poor</li><li>&lt;60 bad</li></ul>
        <p>PSNR (&ge;40 dB excellent) and SSIM (&ge;0.95 excellent) are
        computed alongside with ffmpeg-compatible semantics.</p>"""

    def _get_troubleshooting_content(self) -> str:
        return """
        <h2>Troubleshooting</h2>
        <ul>
          <li><b>No bookends detected</b> — raise loop count, check the
              playback chain actually shows white frames, or lower the white
              threshold (Options &rarr; Advanced). With
              <i>fallback to full video</i> on, the whole capture is used.</li>
          <li><b>Low scores on a good chain</b> — check temporal alignment
              confidence in the analysis log; enable motion compensation for
              chains with spatial misregistration.</li>
          <li><b>No capture hardware</b> — the simulated file-playback device
              exercises the full workflow.</li>
          <li><b>Slow first run</b> — nvcc builds the CUDA kernels once
              (into <code>build/pqa2_tpu_torch/</code>), and the first
              integer-model clip of a process audits the log2 lookup on the
              card; later runs reuse both.</li>
          <li><b>"torch.cuda.is_available() is False"</b> — the window was
              started for a card (the default) on a machine without one;
              start it with <code>--device cpu</code>.</li>
        </ul>"""
