// Fast sensor-data loaders (native dataset ingestion path).
//
// The reference's data path is rosbag replay decoded by roscpp (README.md:
// rosbag play). Without ROS, dataset ingestion is raw-file parsing; these
// loaders keep it native: KITTI velodyne .bin point clouds, fixed-column
// float CSV (EuRoC imu0/data.csv style), and grayscale PGM (P5) images.
// All return counts and fill caller-provided buffers (ctypes-friendly).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// KITTI velodyne .bin: sequence of float32 (x, y, z, reflectance).
// Fills xyz (max_pts * 3 floats) and optionally intensity (max_pts).
// Returns number of points read, or -1 on open failure.
int64_t load_kitti_bin(const char* path, float* xyz, float* intensity,
                       int64_t max_pts) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t n = 0;
    float buf[4];
    while (n < max_pts && std::fread(buf, sizeof(float), 4, f) == 4) {
        xyz[n * 3 + 0] = buf[0];
        xyz[n * 3 + 1] = buf[1];
        xyz[n * 3 + 2] = buf[2];
        if (intensity) intensity[n] = buf[3];
        ++n;
    }
    std::fclose(f);
    return n;
}

// Comma/space-separated float table (EuRoC data.csv after the header line,
// KITTI times.txt, TUM trajectories). Parses up to max_rows * n_cols values.
// skip_lines: header lines to skip. Returns rows parsed, or -1 on failure.
int64_t load_csv_floats(const char* path, double* out, int64_t n_cols,
                        int64_t max_rows, int64_t skip_lines) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[4096];
    for (int64_t i = 0; i < skip_lines; ++i) {
        if (!std::fgets(line, sizeof(line), f)) { std::fclose(f); return 0; }
    }
    int64_t rows = 0;
    while (rows < max_rows && std::fgets(line, sizeof(line), f)) {
        char* p = line;
        int64_t c = 0;
        while (c < n_cols) {
            while (*p == ',' || *p == ' ' || *p == '\t') ++p;
            if (*p == 0 || *p == '\n' || *p == '\r') break;
            char* end = nullptr;
            double v = std::strtod(p, &end);
            if (end == p) break;
            out[rows * n_cols + c] = v;
            p = end;
            ++c;
        }
        if (c == n_cols) ++rows;
    }
    std::fclose(f);
    return rows;
}

// Binary PGM (P5) grayscale image. Fills out (max_h * max_w floats in
// [0, 1]); returns (height << 32 | width) or -1.
int64_t load_pgm(const char* path, float* out, int64_t max_h, int64_t max_w) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    if (std::fscanf(f, "%2s", magic) != 1 || std::strcmp(magic, "P5") != 0) {
        std::fclose(f);
        return -1;
    }
    // skip comments
    int w = 0, h = 0, maxval = 0;
    int vals[3];
    int got = 0;
    while (got < 3) {
        int ch = std::fgetc(f);
        if (ch == '#') {
            while (ch != '\n' && ch != EOF) ch = std::fgetc(f);
        } else if (ch >= '0' && ch <= '9') {
            std::ungetc(ch, f);
            if (std::fscanf(f, "%d", &vals[got]) != 1) { std::fclose(f); return -1; }
            ++got;
        } else if (ch == EOF) {
            std::fclose(f);
            return -1;
        }
    }
    w = vals[0];
    h = vals[1];
    maxval = vals[2];
    std::fgetc(f);  // single whitespace before data
    if (w > max_w || h > max_h || maxval <= 0 || maxval > 255) {
        std::fclose(f);
        return -1;
    }
    uint8_t* row = static_cast<uint8_t*>(std::malloc(w));
    float inv = 1.0f / static_cast<float>(maxval);
    for (int r = 0; r < h; ++r) {
        if (std::fread(row, 1, w, f) != static_cast<size_t>(w)) {
            std::free(row);
            std::fclose(f);
            return -1;
        }
        for (int c = 0; c < w; ++c) out[r * max_w + c] = row[c] * inv;
    }
    std::free(row);
    std::fclose(f);
    return (static_cast<int64_t>(h) << 32) | static_cast<int64_t>(w);
}

}  // extern "C"
