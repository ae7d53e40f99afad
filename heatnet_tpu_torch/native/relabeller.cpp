// Native label-remap kernels — C++ rebuild of the Cython relabeller
// (the reference's data/datasets/c_relabeller/relabeller.pyx:4-58).
//
// relabel_vistas_image: uint16 panoptic map (class*256 + instance) →
// remapped (new_class*256 + dense_instance_id); unmapped classes become
// background*256. Instance ids are renumbered densely in column-major
// first-encounter order, matching the Cython loop (x outer, y inner).
//
// relabel_image: uint8 class map → RGB via a palette (visualization path).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// mapping: array of 256 int32 entries, -1 = unmapped. background: class id
// used for unmapped pixels. Writes `out` (same shape), returns the number of
// distinct instances assigned.
int relabel_vistas_image(const uint16_t* img, uint16_t* out,
                         int height, int width,
                         const int32_t* mapping, int background) {
    std::unordered_map<uint32_t, uint16_t> used_ids;
    used_ids.reserve(1024);
    uint16_t id_counter = 0;
    const uint32_t bg = static_cast<uint32_t>(background) * 256u;

    for (int x = 0; x < width; ++x) {
        for (int y = 0; y < height; ++y) {
            const uint32_t p = img[y * width + x];
            const uint32_t cls = p / 256u;
            const int32_t mapped = mapping[cls & 0xff];
            if (mapped >= 0) {
                auto it = used_ids.find(p);
                uint16_t dense;
                if (it != used_ids.end()) {
                    dense = it->second;
                } else {
                    dense = id_counter++;
                    used_ids.emplace(p, dense);
                }
                out[y * width + x] =
                    static_cast<uint16_t>(static_cast<uint32_t>(mapped) * 256u + dense);
            } else {
                out[y * width + x] = static_cast<uint16_t>(bg);
            }
        }
    }
    return static_cast<int>(id_counter);
}

// palette: 256*3 uint8 RGB entries; unmapped classes (palette row of zeros
// works as "skip") — semantics of relabel_image (relabeller.pyx:38-58).
void relabel_image(const uint8_t* seg, uint8_t* out_rgb,
                   int height, int width, const uint8_t* palette) {
    for (int x = 0; x < width; ++x) {
        for (int y = 0; y < height; ++y) {
            const uint8_t cls = seg[y * width + x];
            uint8_t* dst = out_rgb + (y * width + x) * 3;
            const uint8_t* src = palette + cls * 3;
            dst[0] = src[0];
            dst[1] = src[1];
            dst[2] = src[2];
        }
    }
}

}  // extern "C"
