// 16-bit thermal contrast + binarization operators — C++ rebuild of the
// combinedNode preprocessing (the reference's ros_src/learn_msg_filter/src/
// combinedNode.cpp:37-166), OpenCV-free.
//
// Chain (used for RGB<->IR cross-calibration target extraction):
//   IR16 → float → threshold TRUNC @30000 → min-max normalize → 8-bit →
//   invert → binary threshold @100 ; RGB gray → binary threshold @140.

#include <algorithm>
#include <cstdint>
#include <limits>

extern "C" {

// IR16 → inverted 8-bit contrast-stretched image (out_u8), plus binary mask
// (out_bin, 0/255) at `bin_thresh` (reference: 100).
void thermal_to_8bit(const uint16_t* ir, uint8_t* out_u8, uint8_t* out_bin,
                     int n, float trunc_value, int bin_thresh) {
    float lo = std::numeric_limits<float>::max();
    float hi = std::numeric_limits<float>::lowest();
    for (int i = 0; i < n; ++i) {
        float v = static_cast<float>(ir[i]);
        if (v > trunc_value) v = trunc_value;  // THRESH_TRUNC
        lo = std::min(lo, v);
        hi = std::max(hi, v);
    }
    const float scale = hi > lo ? 255.0f / (hi - lo) : 0.0f;
    for (int i = 0; i < n; ++i) {
        float v = static_cast<float>(ir[i]);
        if (v > trunc_value) v = trunc_value;
        const uint8_t u = static_cast<uint8_t>((v - lo) * scale);
        const uint8_t inv = static_cast<uint8_t>(255 - u);  // invert
        out_u8[i] = inv;
        out_bin[i] = inv > bin_thresh ? 255 : 0;  // THRESH_BINARY
    }
}

// 8-bit grayscale → binary mask at `thresh` (reference RGB path: 140).
void gray_binarize(const uint8_t* gray, uint8_t* out_bin, int n, int thresh) {
    for (int i = 0; i < n; ++i) {
        out_bin[i] = gray[i] > thresh ? 255 : 0;
    }
}

}  // extern "C"
